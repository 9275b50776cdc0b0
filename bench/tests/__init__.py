"""CPU tests of the benchmark (run as ``python -m pytest bench/tests``);
those marked ``cuda`` run on the card."""
