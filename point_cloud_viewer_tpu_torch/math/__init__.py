"""Host geometry of the port: SAT engine, boxes, cubes, frusta."""
