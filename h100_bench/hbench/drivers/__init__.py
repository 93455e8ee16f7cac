"""Traffic shapes: one module a shape, named by a traffic file's ``shape``,
with ``run(ctx) -> Outcome``."""
