"""Plain reference networks, one file per architecture.

A configuration's ``"architecture"`` names its file here,
``benchmark/reference/arch/<architecture>.py``, which ``gan.py`` finds by
that name: a new architecture is a new file, and the step machinery of
``gan.py`` (Adam, the losses, the macro-step) stays shared.  Each file
holds one architecture's networks in plain float32 ``torch`` (through
``benchmark/reference/layers.py``), imports nothing of the program, and
defines three functions:

* ``init_weights(c, seed) -> (gen, critic)``: flat dicts of the initial
  parameters and buffers, keyed by the port's state-dict names, drawn on
  the CPU from ``torch.Generator().manual_seed(seed)`` in the order the
  port documents (the generator first, then the critic, each
  spectral-norm ``u`` after its kernel);
* ``generator(c, p, z, train, cast, update=None)``: latents (B, z_dim) to
  images (B, H, W, C) float32 in [-1, 1]; ``train`` normalises with the
  batch's statistics, and ``update`` (a dict) receives the new BatchNorm
  running averages;
* ``critic(c, p, x, cast, new_u=None)``: images (B, H, W, C) to features
  (B, dof_dim) float32; ``new_u`` (a dict) receives each spectral-norm
  layer's iterated ``u``.

``cast`` is ``layers.py``'s: None in float32, else applied to both
operands of every product run in the configuration's compute dtype.
"""
