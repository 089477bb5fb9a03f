"""Accuracy studies of the port, one module per study, each run as
``python -m vmc_pde_torch.studies.<name>``:

- ``northstar_l2``: ``mwe``'s density against N(0, (1 + 2t) I) on a grid;
- ``accuracy_d8``: the d=8 diffusion entropy against its closed form;
- ``check_aniso``: a ``diffusion_anisotropic`` run against I + 2 D t;
- ``check_fp6``: a ``harmonicOsc_diff`` run against the SDE oracle;
- ``evolve_minsr_largep``: minSR evolution at large P;
- ``evolve_d32_fp``: the d=32 Fokker-Planck main path against the SDE
  oracle and the Lyapunov ODE;
- ``evolve_doublewell``: the ``doubleWell`` quench against the SDE oracle;
- ``compare_student_grid``: Student-t entropy curves against the radial
  grid;
- ``make_paper_figures``: the two paper figures, with ``--run`` their
  runs first.

Each takes the flags of the JAX package's script of the same name under
``scripts/``, with ``--device`` (default cuda; raises without a card) in
place of its backend flags and ``--precision`` where the script's
``--tpu`` also switched the precision. Each prints the script's JSON keys
and text lines. The metrics are plain functions of a recorded infos dict
(``InfoRecorder.as_arrays()``), so they run where h5py and matplotlib are
missing; only reading or writing an ``infos.hdf5`` needs h5py, and only
drawing needs matplotlib.
"""
