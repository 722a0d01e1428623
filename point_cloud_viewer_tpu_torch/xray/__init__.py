"""X-ray quadtrees of the port: the splat reductions on a PyTorch device,
the strategies, the pyramid build, merge, inpaint and the tile server."""
