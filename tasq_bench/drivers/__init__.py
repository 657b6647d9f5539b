"""Window kinds, one module each: ``run(ctx) -> harness.Result``."""
