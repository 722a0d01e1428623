"""Query path of the port: locations, the per-point filter, the client."""
