"""S2 point clouds: cell unions and the reader of S2 clouds."""
