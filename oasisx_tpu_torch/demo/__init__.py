"""The demos on the port, each a module with the JAX package's ``main(argv)``
and return value (``demo/*.py``), run as
``python -m oasisx_tpu_torch.demo.<name>``: ``taylor_green`` (convergence
rates), ``taylor_green3d`` (kinetic energy and dissipation), ``channel``
(Poiseuille), ``cylinder`` (DFG drag and lift), ``vessel`` (pulsatile flow,
tagged Gmsh meshes) and ``assembly_bcs`` (the split-phase assembly under
both strategies).  Each takes ``--device`` (default: the card) and
``--dtype`` (default float32).
"""
