"""The benchmark's tests import the program from ``src``, as the
benchmark's runs do."""
import pathlib
import sys

SRC = str(pathlib.Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
