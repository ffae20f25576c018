"""The plain reference the benchmark holds the program to: plain PyTorch
and numpy, written from the definitions (the reference trainer's loss,
nvdiffrast's antialias semantics, tiny-cuda-nn's hash grid), imports
nothing of the program and takes nothing the program made.

  mesh      the boundary surface, its edge neighbours, the tet adjacency
  raster    clip transform, z-buffer over each face's pixel box, shading,
            interpolation, vertex normals, the pair antialias
  energy    smoothness and barrier energy, its coefficient schedule
  field     hash-grid encoding and MLP of the colour field
  optim     AdamUniform and its cosine learning rate
  steps     the geometry and texture losses over every view and three
            optimizer steps from the seed's start; the antialias's pair
            counts at given vertices
  compare   the numbers that decide ``correct``

A configuration names the module that is its reference (``harness:
{reference: <name>}``, the default ``steps``). It takes the problem its
inputs writer made (``benchmark/inputs/__init__.py``), a ``steps.Problem``
whose ``cfg``, ``weights`` and ``views`` the harness sets, and honours
each: ``views``, when set, are the only views it follows (the half-batch
fault). It provides ``Reference(problem, device, precision)`` with
``.follow(n)``, ``leaf_names(weights)`` and ``pair_counts_of(problem, x,
shaded, device)``, the pair counts under its own projection. A new one may
import the modules above relatively, and nothing else of the benchmark.

``precision="tf32"`` rounds every matrix product's operands to TF32's
10-bit mantissa (what the card's tensor cores do when TF32 is allowed):
the control that must come out as not correct.
"""
