"""The drives: ``drives/<name>.py`` sets up, times and checks every cell
whose traffic file names it (``"drive": "<name>"``). Each module has a
class ``Drive(config, traffic, seed, device)`` with ``setup``, ``window``,
``counts``, ``release`` and ``check``, and a function ``control_readings``
for ``portbench/control.py``. A later cell that needs another entry of the
program adds a module here; no other file changes."""
