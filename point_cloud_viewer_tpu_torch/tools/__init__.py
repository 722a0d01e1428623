"""The port's randomized campaigns: twins of the JAX package's
tools/fuzz_differential.py, tools/fuzz_crash_resume.py and
tools/fuzz_xray.py that drive this package on a PyTorch device.  Each runs
as `python -m point_cloud_viewer_tpu_torch.tools.<name> [seconds]
[--device cuda|cpu]` and has a `main(argv) -> int`."""
