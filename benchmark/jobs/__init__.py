"""Traffic kinds, one module per ``kind`` that a workload file names.

Each module has ``setup(ctx)`` (warm-up; returns the job's state),
``window(ctx, state, seconds)`` (the measured loop; returns
``attempted``, ``failed``, ``e2e`` values by metric name and ``facts``
for the per-layer readers), ``release(state)`` (frees the program's
state), ``verify(ctx, state, win)`` (the plain reference's judgement:
``{name: {"value": v, "limit": l}}``) and ``control(ctx)`` (the
reference in the program's place with one guarantee broken: the
``state`` and window result that ``verify`` then judges; see
``benchmark/control.py``)."""
