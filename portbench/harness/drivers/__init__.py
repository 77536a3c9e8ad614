"""One driver per traffic kind: ``run(cfg, traffic, seed, seconds, trace,
device, t_start)`` sets the cell up, measures its window and returns an
``Outcome``."""
