"""The demos on the port, each a module with the JAX package's ``main(argv)``
and return value (``demo/*.py``), run as
``python -m oasisx_tpu_torch.demo.<name>``: ``taylor_green`` (convergence
rates), ``taylor_green3d`` (kinetic energy and dissipation), ``channel``
(Poiseuille), ``cylinder`` (DFG drag and lift), ``vessel`` (pulsatile flow,
tagged Gmsh meshes), ``assembly_bcs`` (the split-phase assembly under
both strategies) and ``assembly_strategies`` (the pressure-gradient term
by both strategies, timed); each takes ``--device`` (default: the card) and
``--dtype`` (default float32).  The fidelity runs of the JAX package's
scripts: ``fidelity_tgv`` (Taylor-Green Re=1600 on the symmetry sub-box
through the dissipation peak, held against the repository's curves) and
``fidelity_tg3d`` (bench.py's problem in float32 on the card against
float64 on the CPU).
"""
