"""Scripts run by hand (see each module for where: the card or the CPU)."""
