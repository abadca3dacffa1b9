"""Integer-word circuits over the single-key bootstrapped gates.

Port of torus_fhe_tpu/circuits/__init__.py.
"""

from . import words
from .words import (add, bubble_sort, compare_swap, full_adder, int_decrypt,
                    int_encrypt, less_than, minimum, mux_word,
                    ones_complement, subtract)
