"""Native (C++) host-runtime components of the port, built with g++ and loaded via ctypes (``lib.py``)."""
