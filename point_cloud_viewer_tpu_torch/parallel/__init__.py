"""Multi-device builds of the port: a mesh of PyTorch devices driven from
one process (parallel/mesh.py, parallel/sharded_build.py)."""
