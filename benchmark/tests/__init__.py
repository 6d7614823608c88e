"""CPU tests of the benchmark (and one card test, marked `cuda`): python3 -m pytest benchmark/tests -q."""
