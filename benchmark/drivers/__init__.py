"""One driver per traffic kind: what a cell's window runs and how its outputs are judged."""
