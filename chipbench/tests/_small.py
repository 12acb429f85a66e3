"""Small sizes and a few-point grid for the CPU tests (the full-size
cells run on the card only)."""
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]

# configuration -> sizes a CPU sweep of the whole grid takes seconds at
SMALL = {"machsuite-sort_merge": {"n": 16},
         "machsuite-md_knn": {"n_atoms": 8, "max_neighbors": 2}}
# the bench generators' own TINY sizes (the golden schedules' sizes)
TINY = {"machsuite-sort_merge": {"n": 64},
        "machsuite-md_knn": {"n_atoms": 24, "max_neighbors": 4}}
TINY_SEED = {"machsuite-sort_merge": 3, "machsuite-md_knn": 11}

FEW_DESIGNS = [["banked", 1, 1, 1], ["banked", 1, 1, 4],
               ["multipump", 2, 2, 1], ["h_ntx_rd", 4, 1, 4],
               ["hb_ntx", 4, 2, 1], ["remap", 2, 2, 1]]


def few(traffic: dict) -> dict:
    """``traffic`` over six designs at unrolls 1 and 4."""
    return {**traffic, "designs": FEW_DESIGNS, "unrolls": [1, 4]}
