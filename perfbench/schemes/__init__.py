"""One scheme a file, found by a configuration's ``scheme`` (byname.py),
on the reference's side: plain PyTorch, nothing of the program.

A scheme file gives ``make_keys(gen, cfg) -> keys.Keys``, the raw key
material made from the generator as the scheme defines it, and
``Reference(cfg, keys, digits_dropped)``, a ``reference.Gates`` whose
``_bootstrap(a, b)`` is the scheme's plain gate bootstrap of one chunk of
pre-activation samples; ``digits_dropped`` leaves out the last gadget
digits of every external product (the control). Its program side is
perfbench/drive/<scheme>.py.
"""
