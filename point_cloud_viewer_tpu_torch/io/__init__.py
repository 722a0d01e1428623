"""File I/O of the port: PLY reading, per-node files."""
