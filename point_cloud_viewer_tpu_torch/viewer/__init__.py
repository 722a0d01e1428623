"""Viewer runtime of the port: the headless render loop, the GL pipeline,
the windowed SDL shell and the web server, each frame culled on a PyTorch
device (the web server culls on the host, as the JAX package's)."""
