"""The serving plane: frame store, gallery store and ``ServingEngine``."""
