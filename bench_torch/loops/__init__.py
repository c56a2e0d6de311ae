"""Closed loops, one module a loop, named by a traffic mix's ``loop``.

``setup(ctx)`` builds the program's objects from the context, warms every
shape the loop uses and returns an object with ``step(i)`` (one unit; an
answer to sample, or None), ``sync()``, ``release()`` (drop the program's
state, keep what the check needs), ``check(samples)`` (``(name, value)``
pairs against the plain reference); the module's ``CALLS`` names the hooks
(``faults.py``) it makes.
"""
