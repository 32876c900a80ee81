"""One module per configuration ``driver``: the program's objects for a
cell, its units, and the comparison with ``reference/<driver>.py``."""
