"""One module a kind of entry, named as a traffic file's ``entry``: the
general generator that reads the traffic file and drives the program's
entry. ``run.py`` and ``calibrate.py`` find the module by that name and
use its ``Entry``, built as ``Entry(cell, config, traffic, seed, device,
workdir)``, through these methods alone:

* ``setup()``: every shape the cell uses, warmed;
* ``window(seconds)``: the timed work, ``{<end-to-end metric>: value,
  "attempted": n}``; ``traced_window(seconds, tracer)``: the traced work,
  ``{"attempted": n}``; ``metric_context()``: what the per-layer readers
  take beside the trace;
* ``after_window()``: what the program does past the window for the check
  (nothing, where the window's own answers are judged);
* ``release()``: the program's state dropped;
* ``check(sets, weights)``: the compared numbers, against the reference
  (``info``, where set, holds numbers shown and not compared);
* ``control_readings(sets, weights)``: ``{side: numbers}``, the control
  and each planted fault in the program's place, for ``calibrate.py``.

A new kind of entry is one added module here."""
