"""CPU tests of the benchmark (tests that need a card are marked `gpu`)."""
