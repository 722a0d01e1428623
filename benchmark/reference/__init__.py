"""The plain reference of the benchmark: NumPy and plain PyTorch that
import nothing of the program (point_cloud_viewer_tpu_torch) and nothing of
JAX, and take nothing the program made.  It works out from the generated
inputs what the program's outputs must be, and judges them."""
