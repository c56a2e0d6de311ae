"""Matrix generators, one module a generator, each with
``generate(**args) -> Pattern``. Copies of the program's generators, held
here so that a change to the program's copy cannot move the benchmark's
matrices (``selftest.py`` holds them equal at the configured arguments)."""
