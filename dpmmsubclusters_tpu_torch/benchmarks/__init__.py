"""The port's benchmarks, each a module run with ``python -m``:

* :mod:`.kernel_tile_study` -- kernel C's column sums and kernel A at each
  hash tile and block size;
* :mod:`.kernel_ablate` -- kernel D's stage ablation.

They run on ``--device cuda`` by default and time with CUDA events there;
``--device cpu`` runs the plain PyTorch versions (a rehearsal, not a
measurement of the card).
"""
