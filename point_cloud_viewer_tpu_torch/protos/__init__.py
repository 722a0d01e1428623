"""meta.pb wire format of the port (proto3 encoder and decoder)."""
