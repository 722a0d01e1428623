"""Core data model of the port: constants, attributes, PointsBatch."""
