"""The plain reference the benchmark holds the program against.

Frozen copies of the plain PyTorch versions in burn_raymarching_tpu_torch
(the sphere field, the march, the dense and culled renderers, per-tile
selection, the loss, the dataset sampler, the camera, the ground-truth
renderer and the PNG codec), taken when the benchmark was written, with
their imports pointed here. They import nothing of the program, so a later
change to the program cannot move the yardstick. ``step.py`` and
``adam.py`` are the training step and the optimizer written against them.
"""
