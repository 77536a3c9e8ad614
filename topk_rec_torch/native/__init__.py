"""Native host code of the port: the C++ fold and ``.dat`` parser
(``csrc/io_native.cpp``), built at first use by ``ops/_build.py``."""
