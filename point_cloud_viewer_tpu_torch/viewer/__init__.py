"""Viewer runtime of the port (headless render loop with the device cull)."""
