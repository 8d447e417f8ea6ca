"""Native host runtime: the pool allocator and the relation generators,
C++ sources compiled with ``g++`` at first use (see build.py)."""
