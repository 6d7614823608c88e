"""The demos of `python -m nbx_torch demo <name>`, one a program of
`examples/`: galaxy (`galaxy_demo.py`), merger (`merger_demo.py`), granular
(`granular_demo.py`), orbit (`orbit_movie.py`), spatial (`spatial_demo.py`)
and merger_full (`merger_full.py`)."""
