"""Planner: block graph, skip-aware partitioner, schedule synthesis."""
