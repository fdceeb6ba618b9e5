"""Train and serve step builders over a ``ParallelPlan``."""
