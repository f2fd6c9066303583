"""One reader a metric: ``<metric>.py`` holds ``read(run)``, which returns
the metric's value from a run's record, or None when the run has nothing
for it to read. ``run`` is the namespace that ``serve.py`` or
``train.py`` returns; ``run.trace`` is the window's ``trace.Trace`` in a
traced run and None otherwise."""
