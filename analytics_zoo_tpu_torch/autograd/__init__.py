"""The symbolic graph behind functional ``Model``s (port of
``analytics_zoo_tpu.autograd``: ``variable.py`` so far; ``Parameter`` and
the ``AutoGrad``-style math functions are not ported yet)."""
