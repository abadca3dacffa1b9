"""One scheme a file, found by a configuration's ``scheme`` (byname.py),
on the program's side: with program.py, the only files of the benchmark
that import the program.

A drive file gives ``cloud_key(params, cfg, keys, device)``, the program's
cloud key built from the raw key material of perfbench/schemes/<scheme>.py
in the forms the program's normal path reads; ``SAMPLE``, the program's
ciphertext type; ``GATES``, the program's two-input gates by the names of
reference.AFFINE; and ``circuit(name)``, the program's own function of the
circuit perfbench/circuits/<name>.py, called ``(ck, *words, width)``.
"""
