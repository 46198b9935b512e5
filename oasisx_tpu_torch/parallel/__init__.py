"""Sparsity tables of the unstructured operators (``graph``) and the
slab-sharded structured path: ``comm`` (the collectives over
``torch.distributed``), ``slab`` (the slab tables, halo planes and slab
operators), ``launch`` (rank groups) and ``ranks`` (their rank functions and
command line)."""
