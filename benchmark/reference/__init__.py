"""The plain reference that decides ``correct``: plain torch and numpy,
importing nothing of the program or of JAX, and working every table, tree
answer and draw out again from the raw scene files and the seed.

A configuration names its reference module, ``reference/<name>.py``
(``reference``, default ``whitted``), which ``Layout.module`` finds under
any root.  The frames and progressive runners call it through this
interface:

* ``load(path) -> scene``: the scene file read, with its ``camera``
  (``width``, ``height`` settable);
* ``tables(scene, device, dtype=torch.float32) -> tb``: what a trace
  needs, in ``dtype``, with ``tb.counts.closest`` and ``tb.counts.shadow``
  counting the queries traced since;
* ``frame_jitter(frame_seed, n_pixels, n_samples, device)``: a frame's
  in-cell offsets, (S, n_pixels, 2);
* ``multisample(tb, pixels, jitter, n_cells) -> (P, 3)``: the pixels'
  radiance over n_cells^2 stratified samples;
* ``to_u8(col)``: the radiance as the u8 image holds it;
* ``progressive_mean(tb, seed, pixels, upto) -> {k: (P, 3)}``: the mean
  radiance after passes 0..k.

The training runner drives ``whitted`` and ``diffchain`` (the
differentiable chain, on ``whitted``'s tables) and refuses a
configuration that names another reference.
"""
