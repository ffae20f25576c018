"""The inputs writers: what a run reads, made from its seed.

A configuration names its writer (``harness: {inputs: <name>}``, the
default ``mitsuba_spheres``); ``benchmark/inputs/<name>.py`` provides

  make(cell, seed, folder, device) -> (problem, overrides)
      writes the seed's dataset and mesh under ``folder``, where the
      program reads them, and returns the run's overrides and the
      reference's problem: a ``benchmark.reference.steps.Problem`` with
      ``verts``, ``tets``, ``n_spheres``, ``mvp``, ``mv``, ``rgba``,
      ``depth`` and ``normal`` filled, ``cfg`` empty
  weights(material_cfg, seed, device)
      the colour field's starting weights, for the texture stage

The harness then sets the problem's ``cfg`` (the resolved configuration)
and, for the texture stage, its ``weights``; the half-batch fault of
``benchmark/calibrate.py`` sets its ``views`` (which views the reference
follows); the antialias's pair counts read its ``tets``, ``mvp`` and
``rgba``. The configuration's reference honours all of them.

A writer imports nothing of the port; it may import ``benchmark.scene``'s
helpers, ``benchmark.reference`` and its siblings, relatively. The same
seed gives the same inputs, and the sizes never depend on it.
"""
