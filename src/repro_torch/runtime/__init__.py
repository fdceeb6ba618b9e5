"""Pipeline runtime: stage layout, step tables, the wave executor."""
