"""The benchmark's own tests: on the CPU, with the program's plain
versions; a test that needs the card carries the ``cuda`` marker and
decides inside the test whether there is one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
