"""The demos of `python -m nbx_torch demo galaxy|merger` (ports of
`examples/galaxy_demo.py` and `examples/merger_demo.py`)."""
