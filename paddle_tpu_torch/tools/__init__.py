"""Scripts run by hand on a machine with a card (see each module)."""
