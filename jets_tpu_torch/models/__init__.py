from .seismic import (
    make_seismic_operator,
    make_seismic_problem,
    seismic_operator_from_arrays,
)

__all__ = [
    "make_seismic_operator",
    "make_seismic_problem",
    "seismic_operator_from_arrays",
]
