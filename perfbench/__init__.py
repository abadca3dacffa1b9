"""The benchmark of torus_fhe_tpu_torch on one NVIDIA H100: run.py runs one
cell of BENCHMARK.json (a configuration under a traffic mix) and prints its
result line. The harness imports the program in program.py and the scheme
files of drive/ alone."""
