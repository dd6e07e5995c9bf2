"""Plain references, one module a model family, named by the family."""
