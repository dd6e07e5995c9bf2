"""A mix's driver: ``run(rec, seed, device, trace, t_start, log)`` sets up
and runs the window, filling the record; ``check(rec, ref, device, log)``
returns the numbers compared, each with its limit."""
