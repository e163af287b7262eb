"""Device operators: the warp kernel and its twin, resampling, assembly,
and the numpy geometry core."""
