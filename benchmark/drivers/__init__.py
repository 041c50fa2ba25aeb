"""Drivers, one module per kind of traffic; a traffic file names its own
under `driver`.  Each module has a `Cell(cfg, traffic, seed, devices)`
with `warm()`, `window(seconds, annotate)`, `work()`, `check()` and
`use_control()` (the reference at the configuration's control setting in
the program's place), and a `program(...)` that returns the program's
entry the window drives."""
