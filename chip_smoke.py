#!/usr/bin/env python3
"""Smoke test of torus_fhe_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository: ``python3 chip_smoke.py``. It builds the
two blind-rotate kernels from torus_fhe_tpu_torch/csrc with nvcc (one nvcc
per source, started together), holds each against its plain PyTorch version
word for word (both kernels also at batches ragged against each of their
tile shapes and on the first steps of a full-size key, the expanded-key one
as two launches on two streams at once), and drives
these main paths, each with the launch counts set to 0 just before it and
read just after:

- the single-key bootsAND gate bootstrap at tfhe_128_tpu_fast (keygen ->
  encrypt -> gate -> decrypt) and at tfhe_128_tpu, through blind_rotate.cu;
- the batch-sharded bootsAND (parallel/mesh.run_batch_sharded) over two
  mesh slots at tfhe_128_tpu_fast, word-equal to the single-device gate;
- the 3rd-gen multikey gate bootstrap (party keygen -> cloud keygen ->
  encrypt -> mk_gate_and / mk_gate_nand -> decrypt) at mk_2party_3gen
  (expanded key, blind_rotate.cu) and at mk_4party_3gen and mk_8party_3gen
  (compact key, blind_rotate_sel.cu), decrypt-checked, with the boot-noise
  std held to the committed envelope of measurements/ (through N2 below),
  and on each set's key the 3gen row of tools/perf_comp (one NAND batch,
  decrypt-checked, its kernel launched once);
- the party-pipelined multikey bootstrap (parallel/mk_pipeline.py:
  party-sharded key -> mk_bootstrap_pipelined -> NAND -> decrypt) at
  mk_8party_3gen (compact key, B=256, 4 microbatches: 32 launches of
  blind_rotate_sel.cu) and mk_2party_3gen (expanded key, B=1024: 8 launches
  of blind_rotate.cu). Party p runs on a CUDA stream of cuda:(p % device
  count), so on one card every party is a stream of cuda:0. The pipelined
  accumulators must equal the single-call kernel over all steps and the
  plain version stage by stage, word for word;
- P5, the mesh across processes (parallel/ after init_distributed), after
  the sharded ops: the ranks of three groups spawned in turn on the one
  card, each building only its own parties' key shards from the raw samples
  the parent hands over: 8 gloo ranks run the mk_8party_3gen pipelined
  rotate and NAND (compact key, B=256, M=4, one party a rank: 4 launches of
  blind_rotate_sel a rank for each), the party-sharded keyswitch and the
  threshold decryption; 2 gloo ranks the mk_2party_3gen pipelined NAND
  (expanded key, 4.36 GB a rank, B=1024: 4 launches of blind_rotate a rank)
  and the batch-sharded bootsAND (one launch a rank); 1 NCCL rank the
  batch-sharded bootsAND. Every rank's words equal the one-process ones,
  rank 0's NAND decrypts with 0 wrong, the rotate is timed beside the
  one-process one, and a rank that raises or hangs fails the run;
- the wide route, which no kernel takes and the JAX package runs outside
  Pallas too (ops/cuda_rotate.takes_kernel_route): W1, the torch-op scan on
  CUDA tensors == the same scan on CPU tensors at small 64-bit and wide-digit
  geometries; W2, the 3gen multikey gates at mk_16party_3gen, full width and
  depth (16 party keygens, the compact key of the raw 64-bit samples, AND
  and NAND decrypt-checked, boot-noise std against the committed envelope,
  zero launches of either kernel, a ``routes`` line with the counts, and
  where a rotate's time goes: host against device, product against
  expansion against keyswitch); W3, bootsAND at tfhe_80 (Bg = 2^10);
- S1, the key files (utils/serialize.py): the fast set's secret and cloud key
  and the 4-party 3gen cloud key are saved, loaded back onto the card, and
  give the same gate words on the same ciphertexts;
- the circuits and apps, on keys made above (no keygen of their own): at
  tfhe_128_tpu_fast after S1, every gate a launch of blind_rotate.cu, C1 the
  word circuits (a 32-bit adder with carry and a 16-bit less_than at B=1024,
  a bubble sort of six 16-bit words with a payload, eight sorts on the batch
  axis, and a minimum), C2 knn_predict (8 train rows x 4 columns, 12-bit,
  k=3) and its threshold tail (3 of 5, subset {1,2,4}, bounds 0.0125 to 1e-3)
  on the card, C3 conv2d (6x6, two 3x3 filters in [-2, 2], 10-bit) and conv3d
  (3^3, one 2^3 filter, 8-bit); on each multikey set's key right after its
  gates, M1 the 3gen integer circuits (mk_2party_3gen, blind_rotate.cu: 8-bit
  mk_add, mk_int_mul and a 4-word mk_bubble_sort, and mk_conv2d of a 3x3 image
  with two 2x2 kernels, 6-bit; mk_4party_3gen, blind_rotate_sel.cu: 6-bit
  mk_add and mk_int_mul), M2 volume_match (4 buys x 4 sells, 10-bit) and M3
  mk_knn_predict (4 x 3, 8-bit, k=3, two test rows on the batch axis) with
  mk_threshold_tail on the card (ring 1,040), both at mk_2party_3gen. Each
  circuit phase runs with the launch counts at 0 and each launch's CUDA
  events kept, must launch its set's kernel and no other (the tails none),
  prints its bootstraps (a MUX counts two), launches, wall time and the
  kernels' share of it, and is decrypted and held against a numpy oracle:
  one wrong word fails the run;
- the rest of threshold and the auxiliary modules, on the fast set's keys
  after C3, each path with the counts at 0 just before it and read just
  after: D1, public-key encryption (20 encryptions of zero, 1,024 bits under
  the public key, a gate_and of two such batches) and public sampling
  (public_sample of 1,024 messages from a seed batch, the noise std of
  fresh_zero within 10% of a plain gate's) and rlwe_extract_sample_at at
  three coefficients; D2, a packing key (l = 3, 2^8) into a fresh ring key
  of the fast set's ring, pack_lwes of 4 x 512 gate outputs, decoded, the
  packing noise under 1/16, the card's words equal to the CPU's for one
  ciphertext; D3, additive 2- and 4-party splits of the LWE key decoding the
  public-key AND, the bound sweep 1.0 -> 1e-2, TlweTwoTwo's ring N = 2^20
  (2 of 2, 16 bits), the limb FFT product on the card against the CPU's and
  the exact product (2^20, within 2^12) and equal to the exact one at
  N = 4,320, and Shamir 3 of 5 from two subsets; T8, right after the
  8-party gates, mk_threshold_tail of one AND output (ring 4,320, the FFT
  product on the card) at all four bounds; D4, the CLI in a temporary
  directory through cli.main: keygen, encrypt, eval and, decrypt, convert,
  tlwetn 3 5 1 2 4 and knn on a synthetic 8 x 4 CSV, and --help as a
  subprocess;
- the 1st-gen (CCS) and 2nd-gen (KMS) multikey schemes (mk/ccs.py,
  mk/kms.py), torch ops on the card that launch neither kernel (the JAX
  package runs both outside Pallas), each with the counts at 0 before it:
  E1, mk_2party_ccs at full registry width (n = 560, N = 1024, l = 3,
  Bg = 2^9, 1,120 CMux steps, 32-bit): party and cloud keygen on the card, a
  NAND batch of 256 over all four input pairs, decrypted, its noise through
  N4's report (KMS: 0 wrong and max |phase - ideal| < 1/16; CCS: the std
  against its prediction and the wrong count it allows), its wall time, int8
  products, the host/device split of a step and the bound from shapes; E2, mk_2party_kms at full width (N = 2048,
  64-bit): the same with fast_boot, its rotates and its relinearisation
  timed apart, and a fast_boot=False batch of 16; E3, both schemes at the
  test sets (2 and 3 parties, and 4 parties with the 8-party sets'
  gadgets) on the same keys on the card and the CPU, equal words, and a
  save -> load round trip of each full-width key on the card giving the
  same NAND words; E4 (CCS) and E5 (KMS) after E3, the sets above 2
  parties at full registry width: mk_4party_ccs, mk_8party_ccs,
  mk_4party_kms (B = 256) and mk_8party_kms (B = 128); E6 after E5, the
  16-party sets mk_16party_ccs and mk_16party_kms (B = 64), which the JAX
  package never ran. Their keygens run on the CPU in six worker processes
  started at the top of the run (tools/perf_comp.start_keygens: one a set,
  a CPU generator from a fixed seed each; the host's cores and the free
  bytes of their directory logged first), while the card runs the phases
  above, and hand each key over as the JAX key's numpy fields
  (bridge.{ccs,kms}_cloud_key_from_numpy). Per set: keygen seconds and the
  shares of build_sel, tgsw_encrypt and keyswitch_keygen in it, the key's
  bytes on the card equal to those from the set's shapes, one NAND batch
  over all four input pairs through tools/perf_comp.row: decrypted, its
  noise from the same batch (E1's and E2's bounds; CCS against
  ccs_noise_std on the key), no kernel launch, the int8 products (CCS:
  steps x (P+3) + P), wall seconds, gates/s, peak memory; then the
  host/device split of a CMux step on a 64-step chunk, the bound from
  shapes, and a ``routes`` line;
- the measurement modules (utils/noise.py, utils/profiling.py), each run with
  the counts at 0 before it and read after, each NoiseReport's JSON and each
  profile on a line of its own: N1, measure_single_key at tfhe_128_tpu_fast,
  16,384 trials with its own keygen, 0 wrong, both rounded-phase classes 0,
  boot-noise std within NOISE_BAND of the committed 0.004520; N2, the 3gen
  report step on the keys multikey() and wide_route() hold (300 trials at 2,
  4, 8 parties, 128 at 16: their noise check, 0 wrong, std against the
  envelopes, the pre-keyswitch std beside JAX's), and the public
  measure_multikey at mk_2party_3gen; N3, the exact 64-bit route
  (fast_form=False: the lines of the raw samples, no kernel) at mk_2party_3gen,
  300 trials, its key through cache_path, std against the committed exact
  envelope, the ms a step split into host and device; N4, the CCS and KMS
  report steps on E1's and E2's keys (256 trials: their noise check); N5,
  tools/profile_trace.trace of one bootsAND at the fast set (B=1024; this
  is B3, so the split must also hold the keyswitch's int8 GEMM) and of one
  8-party AND (B=256), one untraced call and then a whole trace, the rotate
  kernel the largest category, the traced window's busy share; N6, run_mk_pipeline at
  mk_4party_3gen (compact key) on a synthetic cardio-format CSV, every
  prediction equal to plaintext_oracle and the threshold tail on ring 4 n.
  N2, N4 and N5 run where their keys are held; N1, N3 and N6 after E5;
- the main path's measurement tools, right after N5, each with the counts
  at 0 before it and read after, each line with the card's name and power
  limit: B1, tools/bench.measure on the fast set's key at B=4096 and on
  tfhe_128_tpu's at B=1024 (the AND and the 8-NAND chain decrypt-checked,
  dispatched and chained gates/s, the p50 at B=1, 27 launches of
  blind_rotate, 17 of them timed; bench.py's JSON line); B2, tools/profile's
  table at tfhe_128 (N=1024, l=3, no body drop: 8 limb columns) on a key of
  its own, freed after: the full key's kernel == its plain version on one
  AND batch of B=1024, timed beside its bound, the latency tile (B <= 3)
  == its plain version on the same full key at B = 1 and 3 in both init
  modes, B = 1 timed beside its bound, then the rows at B=1024 (92
  launches; the 8-bit adder's words decrypt-checked); B3 is N5's first
  trace;
- the key forms and routes the user chooses (boot/bootstrap.py's
  ``forms=`` and ``set_rotate_backend``), each with the counts at 0 before
  it and each line with the card's name and power limit: V1, the
  single-key scan route (the CMux chain of mux_rotate over the packed
  TGSW kernels, the conv form rebuilt from the samples of the main path's
  keys, torch ops) against the kernel's route ("auto", blind_rotate.cu in
  stepvec mode) on one key, bootsAND at tfhe_128_tpu_fast B=64 (after S1)
  and tfhe_128_tpu B=16 (after its gate): equal words, 0 wrong, no launch
  on the scan route and one on the kernel's, both times, the conv key's
  bytes from shapes and the int8 products; V2 and V3, inside E1 and E2
  (whose keygens build the fb and conv forms at once): the NAND of 16 pairs
  on the conv form (mk_2party_ccs; mk_2party_kms with fast_boot True and
  False) == on the fb form, no launch; V4, after E5, the host native
  runtime (ops/native.py) built with g++, share_secret_streaming at
  thfhe_1024 3 of 5 through it == the numpy path, the shares decrypting on
  the card.

The compact kernel is also held against the expanded one on the full
2-party key, each kernel against its plain version on one pipeline stage
in explicit-accumulator mode, the party-sharded keyswitch and threshold
decryption against their single-device forms, and the tiny-parameter mesh
dry run (parallel/dryrun.py) runs on 8 slots. Each phase prints one line;
the first failure ends the run with a non-zero code. The last six lines
are the ``circuits`` record (per circuit phase: bootstraps, launches, wall
seconds, bootstraps/s, kernel seconds and share), the ``threshold_aux``
record of D1-D4 (times, noise, the packing and FFT products' milliseconds,
peak memory and bounds), the kernels' JSON record
(launches over every main path, the circuits and D1-D4 included; each kernel's time
and its plain version's at its main shape, beside the bound computed from
the shapes; no single PyTorch call computes a CMux chain, so library_ms is
null, and a yardstick line, labelled partial, gives n times the one
torch._int_mm of a plain step), the
``routes`` record of the wide route and of E1-E6 (per set: no launch of either
kernel, and its count of int8 products; for CCS and KMS also keygen, key bytes,
NAND seconds, noise, the time split and bound, the key file), the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": ...}. Without a CUDA device, or
outside the repository, it fails and prints no result. It imports no JAX.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
DEVICE = "cuda"
SMI = ""  # the card's name and power limit, as nvidia-smi gives them
SEED = 0
MAIN_BATCH = 1024
CHAIN = 4
# 3gen sets of the multikey path: (registry name, parties, batch)
MK_SETS = (("mk_2party_3gen", 2, 1024), ("mk_4party_3gen", 4, 256),
           ("mk_8party_3gen", 8, 256))
# boot-noise std of the AND output, 300 trials of the JAX package
# (measurements/noises__mk_{2,4,8}party_3gen_trials-300.dat); the port's must
# lie within NOISE_BAND times it
NOISE_ENVELOPE = {"mk_2party_3gen": 0.01427, "mk_4party_3gen": 0.01448,
                  "mk_8party_3gen": 0.01669, "mk_16party_3gen": 0.00983}
NOISE_BAND = (0.75, 1.33)
# the set whose shapes each kernel's JSON times are taken at
MAIN_SHAPE = {"blind_rotate": "tfhe_128_tpu_fast", "blind_rotate_sel": "mk_8party_3gen"}
RAGGED = (1, 37, 130)  # batches ragged against the 16-, 64- and 128-gate tiles
SEL_RAGGED = (1, 37, 130, 256)  # the compact kernel's: one tile, ragged ones, several
PIPE_REPS = 3  # timed repetitions of a pipelined rotate: min, median, max are printed
# the party-pipelined sets (parallel/mk_pipeline.py): batch, and the key form
# whose kernel every stage launches
PIPE_BATCH = {"mk_8party_3gen": 256, "mk_2party_3gen": 1024}
PIPE_FORM = {"mk_8party_3gen": "compact", "mk_2party_3gen": "expanded"}
MICROBATCHES = 4
STAGE_BATCH = 64  # one microbatch at 8 parties
# the wide route. W1: (tag, N, l, log2 Bg, torus bits) at k = 1, steps, batches
WIDE_SMALL = (("N=64 l=1 Bg=2^26 64-bit", 64, 1, 26, 64), ("N=64 l=2 Bg=2^18 64-bit", 64, 2, 18, 64),
              ("N=64 l=2 Bg=2^10 32-bit", 64, 2, 10, 32))
WIDE_STEPS = 21
WIDE_RAGGED = (1, 37)
WIDE_SET = ("mk_16party_3gen", 16, 128)  # W2: registry name, parties, batch
TFHE80_BATCH = 256  # W3
S1_MK_SET = "mk_4party_3gen"  # the 3gen key that S1 saves and loads
# E1, E2: the CCS and KMS sets at full registry width (registry name, batch)
SCHEME_SETS = (("mk_2party_ccs", 256), ("mk_2party_kms", 256))
KMS_SLOW_BATCH = 16  # E2: the fast_boot=False batch
# E3: card against CPU at test_parameters_{ccs,kms}: (parties, the registry
# set whose gadgets replace the test set's, or None for the test set's own)
E3_SETS = ((2, None), (3, None), (4, "8party"))
# E4 (CCS) and E5 (KMS): the sets above 2 parties at full registry width
# (registry name, batch); mk_8party_kms at B=128, whose 3B = 384 TLev rows a
# party stay under the 2-party set's 512. E6: the 16-party sets, which
# neither package had run, at B=64 (3B = 192 TLev rows a KMS party). Their
# keygens run in worker processes started at the top of smoke(), while the
# card runs the earlier phases, and hand the keys over as the JAX key's
# numpy fields.
MULTI_SCHEME_SETS = (("mk_4party_ccs", 256), ("mk_8party_ccs", 256), ("mk_4party_kms", 256),
                     ("mk_8party_kms", 128), ("mk_16party_ccs", 64), ("mk_16party_kms", 64))
# the gadget fields of each scheme's parameter set
GADGET_FIELDS = {"ccs": ("bs_decomp_length", "bs_log2_base"),
                 "kms": ("gsw_decomp_length", "gsw_log2_base", "lev_decomp_length",
                         "lev_log2_base", "uni_decomp_length", "uni_log2_base")}
KEYGEN_WAIT_S = 600  # E4-E6 wait at most this long for a keygen worker still running
V1_BATCH = {"tfhe_128_tpu_fast": 64, "tfhe_128_tpu": 16}  # V1: the scan route's batch a set
V_BATCH = 16  # V2, V3: the conv routes' batch
CONV_FIELDS = {"ccs": ("d_kern", "f0_kern", "f1_kern"), "kms": ("gsw_kern",)}
FB_FIELDS = {"ccs": ("d_sel", "f0_sel", "f1_sel", "pk_fb", "sk_fb"), "kms": ("gsw_sel",)}
V4_SHARING = ("thfhe_1024", 3, 5)  # V4: the set whose ring key is shared, t of p
# circuit phases. C1 (tfhe_128_tpu_fast): (width, batch) of the adder, the
# comparator and the minimum; (width, words, independent sorts) of the sort
C1_ADD, C1_LESS, C1_MIN, C1_SORT = (32, 1024), (16, 1024), (16, 64), (16, 6, 8)
C2_KNN = (8, 4, 12, 3)  # train rows, columns, width, k; one test row
C3_CONV2D = (6, 2, 3, 10)  # image side, filters, kernel side, width; weights in [-2, 2]
C3_CONV3D = (3, 1, 2, 8)  # volume side, filters, kernel side, width
# M1 per 3gen set: (width, batch) of mk_add and mk_int_mul, (width, words,
# batch) of mk_bubble_sort, (image side, channels, kernel side, width) of mk_conv2d
M1_SETS = {"mk_2party_3gen": {"add": (8, 256), "mul": (8, 64), "sort": (8, 4, 8),
                              "conv": (3, 2, 2, 6)},
           "mk_4party_3gen": {"add": (6, 64), "mul": (6, 16)}}
M2_VOLUME = (4, 4, 10)  # buys, sells, width (mk_2party_3gen)
M3_KNN = (4, 3, 8, 3, 2)  # train rows, columns, width, k, test rows (mk_2party_3gen)
CIRCUITS = {}  # phase -> its record: the "circuits" JSON line
# D1-D4, the rest of threshold and the auxiliary modules, on the fast set's keys
PACK_SHAPE = (4, 512)  # D2: packed ciphertexts x LWE samples packed into each
PACK_GADGET = (3, 8)  # D2: the packing key's l and log2 of its base
ADDITIVE_PARTIES = (2, 4)  # D3: additive splits of the fast set's LWE key
ADDITIVE_BOUND = 2**-10  # D3: smudging stddev a party of the decoded split
HUGE_RING = 1 << 20  # D3: TlweTwoTwo's ring, k = 1, 2 of 2
TAIL_RING = 4320  # the 8-party tail's ring: 8 x 540
FRESH_NOISE_BAND = 0.1  # D1: |fresh_zero noise std / a gate's - 1| at most this
FFT_TOL = 2**12  # |diff| of two f64 FFT products, wrap-aware: < 2^-20 of the torus
CLI_PARAMS = "tfhe_128_tpu_fast"  # D4
CLI_KNN = (7, 1, 4, 12, 3)  # D4: train rows, test rows, columns, width, k
AUX = {}  # phase -> its record: the "threshold_aux" JSON line
# N1-N6: the noise harness (utils/noise.py) and the profile (utils/profiling.py)
N1_TRIALS = 16384  # the committed run's count
N1_ENVELOPE = 0.004520  # boot-noise std, measurements/log__tfhe_128_tpu_fast_trials-16384.log
N2_TRIALS = {"mk_2party_3gen": 300, "mk_4party_3gen": 300, "mk_8party_3gen": 300,
             "mk_16party_3gen": 128}
# pre_ks_noise_std of measurements/log__mk_{2,4,8,16}party_3gen_trials-300.log; the
# port's is held to NOISE_BAND times it where it is above PRE_KS_GATE
PRE_KS_JAX = {"mk_2party_3gen": 0.00845, "mk_4party_3gen": 0.00190, "mk_8party_3gen": 0.00907,
              "mk_16party_3gen": 2.46e-5}
PRE_KS_GATE = 1e-4
N3_SET, N3_TRIALS = "mk_2party_3gen", 300  # the exact route
N3_ENVELOPE = 0.01625  # measurements/log__mk_2party_3gen_trials-300_exact.log
N4_TRIALS = 256  # the CCS and KMS report steps
# B1-B3: the main path's measurement tools. B1 tools/bench.measure (batch a
# set): first call 1 + 4 dispatched + 8 warm-up chain + 8 chain + 1 warm-up
# B=1 + 5 at B=1 launches, 4 + 8 + 5 of them in the timed windows
BENCH_BATCH = {"tfhe_128_tpu_fast": 4096, "tfhe_128_tpu": 1024}
BENCH_LAUNCHES, BENCH_TIMED = 27, 17
# B2 tools/profile at tfhe_128 (set, batch, iters): XOR 1 + 3, half adder
# 2 x (1 + 3), the adder 40 gates x (1 + 1) launches
PROFILE_SET = ("tfhe_128", 1024, 3)
PROFILE_LAUNCHES = 4 + 8 + 80
# B2's batches of the latency tile on the full tfhe_128 key: one gate (a
# circuit's launch) and 3
LATENCY_CHECK = (1, 3)
N6_KNN = ("mk_4party_3gen", 4, 5, 2, 8, 3)  # set, parties, train rows, test rows, width, k
# P5: the mesh across processes on the one card: (backend, ranks, tasks) of
# each group, spawned in turn; every rank runs on cuda:0, so the groups of
# several ranks take gloo (NCCL refuses two ranks on one GPU)
P5_GROUPS = (("gloo", 8, ("mk_8party_3gen", "keyswitch", "threshold")),
             ("gloo", 2, ("mk_2party_3gen", "gate")),
             ("nccl", 1, ("gate",)))
P5_COLLECTIVE_S = 120  # the process group's timeout: a collective waits at most this long
P5_JOIN_S = 300  # a group's ranks end within this, or the run fails


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def sync_time(fn):
    """(result, host seconds) of fn, synchronised on the card."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn on the card, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_once(fn):
    """(result, milliseconds) of one cold call of fn on the card, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def rand_i32(rng, shape, lo=-2**31, hi=2**31):
    return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)).to(DEVICE)


def rand_torus(rng, shape, bits: int) -> np.ndarray:
    """Uniform torus words of ``bits`` bits, host numpy."""
    words = rng.integers(-2**(bits - 1), 2**(bits - 1), shape, dtype=np.int64)
    return words.astype(np.int32 if bits == 32 else np.int64)


def enqueue_and_total(fn):
    """(result, host seconds until fn returned, host seconds until the card
    finished) of one call of fn."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    t_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    return out, t_enqueue, time.perf_counter() - t


def device_busy(fn):
    """(milliseconds the card's kernels ran during one call of fn, the five
    longest as 'name ms'), from utils.profiling; (None, []) where the trace
    shows no device lane."""
    import tempfile

    from torus_fhe_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            fn()
            torch.cuda.synchronize()
        if not profiling.has_device_lanes(tmp):
            return None, []
        s = profiling.summarize_trace(tmp, top=5)
    return s["total_device_us"] / 1e3, [f"{name[:48]} {us / 1e3:.2f}" for name, us, _ in s["by_op"]]


def launched(fn):
    """(fn's result, launches of each kernel, wall seconds) of one call of
    fn, with the kernels' counts at 0 just before it and read just after."""
    from torus_fhe_tpu_torch.ops import cuda_rotate

    torch.cuda.synchronize()
    reset_launches(cuda_rotate)
    out, wall = sync_time(fn)
    return out, {"blind_rotate": cuda_rotate.blind_rotate_cuda.launches,
                 "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda.launches}, wall


def check_report(tag: str, rep, envelope: float, pre_ks_jax=None,
                 classes: bool = False) -> None:
    """Hold a NoiseReport to 0 wrong and its boot-noise std to NOISE_BAND
    times ``envelope``; its pre-keyswitch std to the band around JAX's where
    that is above PRE_KS_GATE; with ``classes``, both rounded-phase classes
    to 0. Prints the report's JSON on a line of its own."""
    band, ratio = NOISE_BAND, rep.boot_noise_std / envelope
    fails = [f"{rep.wrong_decryptions} wrong"] if rep.wrong_decryptions else []
    if not band[0] <= ratio <= band[1]:
        fails.append(f"boot-noise std {rep.boot_noise_std:.5f} = {ratio:.3f}x {envelope}, "
                     f"outside {band}")
    pre = ""
    if pre_ks_jax is not None:
        pre_ratio = rep.pre_ks_noise_std / pre_ks_jax
        pre = f"; pre-keyswitch std {rep.pre_ks_noise_std:.3g} = {pre_ratio:.3f}x JAX's {pre_ks_jax}"
        if pre_ks_jax > PRE_KS_GATE and not band[0] <= pre_ratio <= band[1]:
            fails.append(f"pre-keyswitch std {pre_ratio:.3f}x JAX's, outside {band}")
    if classes and (rep.wrong_phase_gt_quarter or rep.wrong_phase_lt_zero):
        fails.append(f"rounded-phase classes {rep.wrong_phase_gt_quarter} > 1/4, "
                     f"{rep.wrong_phase_lt_zero} < 0")
    log(tag, f"{rep.trials} trials: {rep.wrong_decryptions} wrong; boot-noise std "
        f"{rep.boot_noise_std:.5f} ({ratio:.3f}x {envelope}), max {rep.boot_noise_max:.5f}; fresh "
        f"std {rep.fresh_noise_std:.3g}{pre}; rounded phase > 1/4: {rep.wrong_phase_gt_quarter}, "
        f"< 0: {rep.wrong_phase_lt_zero}; gate {rep.bootstrap_wall_s:.3f} s; keys "
        f"{rep.bk_bytes / 1e6:.1f} + {rep.ks_bytes / 1e6:.1f} MB")
    print(json.dumps({"noise": tag, **json.loads(rep.to_json())}), flush=True)
    if fails:
        raise AssertionError(f"{tag}: " + "; ".join(fails))


def mk_report(sks, ck, scheme: str, trials: int, gen, rng, dev):
    """(NoiseReport, launches of each kernel, wall s) of the multikey report
    step (utils/noise.report_multikey) on a key held here: ``trials``
    random messages, their encryptions and encryptions of True."""
    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.utils import noise

    keys = [sk.lwe for sk in sks]
    msgs = torch.from_numpy(rng.integers(0, 2, trials).astype(bool)).to(dev)
    ct = mk.mk_encrypt(gen, keys, msgs, ck.params)
    true_ct = mk.mk_encrypt(gen, keys, torch.ones(trials, dtype=torch.bool, device=dev), ck.params)
    return launched(lambda: noise.report_multikey(sks, ck, msgs, ct, true_ct, scheme))


def noise_3gen(name: str, sks, ck, gen, rng, dev) -> dict:
    """N2: the 3gen report step on a key held here, N2_TRIALS[name]
    messages: 0 wrong, boot-noise std within NOISE_BAND of the envelope, the
    pre-keyswitch std beside JAX's. Returns the launches of each kernel."""
    rep, counts, _ = mk_report(sks, ck, "3gen", N2_TRIALS[name], gen, rng, dev)
    check_report(f"N2 {name}", rep, NOISE_ENVELOPE[name], pre_ks_jax=PRE_KS_JAX[name])
    return counts


def profile_phase(tag: str, rotate: str, fn) -> tuple:
    """N5: tools/profile_trace.trace of fn, one untraced call and then
    traces under utils.profiling.device_trace until one is whole (it kept
    its body's records and the rotate kernel's), up to profile_trace.TRIES.
    The rotate kernel's category ``rotate`` must be the largest, and the
    categories must add up to the device total within 1%. Prints a
    ``profile`` JSON line; returns (the summary, the launches of each
    kernel over the untraced call and all traces)."""
    import tempfile

    from torus_fhe_tpu_torch.tools import profile_trace

    with tempfile.TemporaryDirectory() as tmp:
        s, counts, wall = launched(lambda: profile_trace.trace(fn, DEVICE, tmp, rotate))
    cats, total, share = s["by_category"], s["total_device_us"], s["busy_share"]
    print(json.dumps({"profile": tag, "total_device_us": total, "by_category": cats,
                      "window_us": s["window_us"], "busy_share": share, "traces": s["traces"],
                      "intact": s["intact"], "guards": s["guards"],
                      "top": [[name[:80], us, pct] for name, us, pct in s["by_op"][:5]]}),
          flush=True)
    if not s["whole"] or share is None:
        raise AssertionError(f"{tag}: all {s['traces']} traces lost records of the body "
                             f"(intact {s['intact']}) or the rotate kernel's: {cats}")
    log(tag, f"{s['traces']} trace(s); device total {total / 1e3:.3f} ms of a "
        f"{s['window_us'] / 1e3:.3f} ms window: busy share {share:.4f}; " + ", ".join(
            f"{c} {us / 1e3:.3f} ms" for c, us in cats.items())
        + f"; {wall:.1f} s; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{SMI}]")
    if not cats or max(cats, key=cats.get) != rotate:
        raise AssertionError(f"{tag}: the largest category is not {rotate}: {cats}")
    if abs(sum(cats.values()) - total) > 0.01 * total:
        raise AssertionError(f"{tag}: categories add to {sum(cats.values())}, total {total}")
    return s, counts


def scan_split(sel, bara, acc, args):
    """Where a step of the torch-op scan goes, on one 64-step chunk of the
    compact lines ``sel`` (B gates): (the chunk's wall s, its host-enqueue
    s, the card's kernel ms of it or None, its five longest kernels, the
    chunk's wall s at one gate: the host's share)."""
    from torus_fhe_tpu_torch.ops import fblock

    one_chunk = lambda: fblock.blind_rotate_streamed(acc, sel[:64], bara[:, :64], *args)
    _, c_enq, c_tot = enqueue_and_total(one_chunk)
    busy_ms, top = device_busy(one_chunk)
    one_gate = lambda: fblock.blind_rotate_streamed(acc[:1], sel[:64], bara[:1, :64], *args)
    one_gate()
    return c_tot, c_enq, busy_ms, top, min(sync_time(one_gate)[1] for _ in range(3))


def scan_shapes(B: int, geom, log2_base: int):
    """(rows, K, cols, limb blocks) of the scan's one int8 product a step at
    B gates, and the rotate's bound from shapes in ms (2 ops a MAC as
    multiplied, at the int8 peak)."""
    from torus_fhe_tpu_torch.ops import cuda_rotate, poly

    nl = len(poly.digits_to_i8_rows(torch.zeros((1, 8), dtype=torch.int32), log2_base))
    rows, K, cols = nl * B * geom.nb, geom.D * geom.R * geom.bs, len(geom.cols) * geom.bs
    return (rows, K, cols, nl), 2 * geom.n * rows * K * cols / cuda_rotate.INT8_OPS_PER_S * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from torus_fhe_tpu_torch.tools import perf_comp

    try:
        return smoke()
    finally:  # E4-E6's keygen workers
        perf_comp.stop_keygens()


def smoke() -> int:
    """Every phase in order, E4-E6's keygen workers started first (one a
    MULTI_SCHEME_SETS set, spawned, the CPU only, each writing its key into
    a directory of one temporary directory), after a line with the host's
    cores and that directory's free bytes."""
    import os
    import tempfile

    from torus_fhe_tpu_torch.boot import api, bootstrap, gates
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.core.torus import decode_message
    from torus_fhe_tpu_torch.lwe import lwe_noiseless_trivial
    from torus_fhe_tpu_torch.ops import cuda_rotate, fblock
    from torus_fhe_tpu_torch.tools import perf_comp

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    global SMI
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    SMI = smi
    log("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    tmp = tempfile.gettempdir()
    log("E4-E6 keygens", f"host: {os.cpu_count()} cores, {shutil.disk_usage(tmp).free / 1e9:.1f} "
        f"GB free in {tmp}")
    perf_comp.start_keygens([(name, P.PARAMETER_REGISTRY[name](), SEED + 500 + i, ("fb",), None)
                             for i, (name, _) in enumerate(MULTI_SCHEME_SETS)], prefix="e46_")
    log("E4-E6 keygens", f"{len(MULTI_SCHEME_SETS)} worker processes started: "
        f"{', '.join(name for name, _ in MULTI_SCHEME_SETS)}")

    # 2. build
    t = time.perf_counter()
    built = cuda_rotate.build()
    for name, (so, report) in built.items():
        cuda_rotate._library(name)
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        log("build", f"{so}; ptxas: {' || '.join(regs)}")
    log("build", f"{len(built)} kernel libraries in {time.perf_counter() - t:.1f} s")

    def compare(tag, fb, geom, tg, acc, bara, barb, mu):
        """Kernel == plain version, word for word, in both init modes."""
        args = (geom, tg.decomp_length, tg.log2_base, tg.offset)
        for mode, a, sv in (("acc", acc, None), ("stepvec", None, (mu, barb))):
            got = cuda_rotate.blind_rotate_cuda(a, fb, bara, *args, stepvec=sv)
            err = max_diff(got, fblock.blind_rotate_fblock(a, fb, bara, *args, stepvec=sv))
            if err:
                raise AssertionError(f"kernel != plain at {tag} {mode}: max |diff| {err}")
        log("kernel==plain", f"{tag}: B={bara.shape[0]} steps={fb.shape[0]} both modes equal")

    # 3. kernel against the plain version at small geometries
    rng = np.random.default_rng(SEED)
    base = P.test_parameters(n=12, N=64)
    twin = P.SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                             "rlwe_mask_size": 2, "bk_drop_limbs": 1})
    odd = P.SchemeParams(**{**twin.__dict__, "bs_decomp_length": 1})  # R*bs = 192: the 64-byte-stage tile
    for tag, params in (("test N=64 k=1", base), ("test N=256 k=1", P.test_parameters(n=12, N=256)),
                        ("k=2 l=2 Bg=2^8 drop-1 N=64", twin), ("k=2 l=1 Bg=2^8 drop-1 N=64", odd)):
        _, ck = api.make_key_pair(torch.Generator().manual_seed(SEED), params, device=dev)
        N, C = params.rlwe_polynomial_degree, params.rlwe_mask_size + 1
        for B in RAGGED:
            compare(tag, ck.bootstrap_key.fb, bootstrap.bk_geometry(params), params.tgsw,
                    rand_i32(rng, (B, C, N)), rand_i32(rng, (B, params.lwe_size), 0, 2 * N),
                    rand_i32(rng, (B,), -N, N), 1 << 29)

    # keys of the main path: tfhe_128_tpu_fast
    fast = P.tfhe_parameters_128_tpu_fast()
    gen = torch.Generator().manual_seed(SEED)
    (sk, ck), t_keygen = sync_time(lambda: api.make_key_pair(gen, fast, device=dev))
    _, t_fb = sync_time(lambda: bootstrap.rebuild_bk_forms(
        ck.bootstrap_key.samples, fast, device=dev))
    geom = bootstrap.bk_geometry(fast)
    N, C = fast.rlwe_polynomial_degree, fast.rlwe_mask_size + 1
    log("keygen", f"tfhe_128_tpu_fast: {t_keygen:.2f} s (F-block build {t_fb:.2f} s), "
        f"fb {tuple(ck.bootstrap_key.fb.shape)} = {ck.bootstrap_key.fb.numel() / 1e9:.2f} GB")
    for B in RAGGED + (64,):
        compare("tfhe_128_tpu_fast key, first 16 steps", ck.bootstrap_key.fb[:16], geom,
                fast.tgsw, rand_i32(rng, (B, C, N)), rand_i32(rng, (B, 16), 0, 2 * N),
                rand_i32(rng, (B,), -N, N), gates.EIGHTH[1])

    # 4. main path: encrypt, bootsAND, a NAND chain, decrypt
    x = torch.from_numpy(rng.integers(0, 2, MAIN_BATCH).astype(bool)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, MAIN_BATCH).astype(bool)).to(dev)
    cx, cy = api.encrypt(gen, sk, x), api.encrypt(gen, sk, y)
    torch.cuda.synchronize()
    reset_launches(cuda_rotate)
    out, t_and = sync_time(lambda: gates.gate_and(ck, cx, cy))
    chain = [cx]
    for _ in range(CHAIN):
        chain.append(gates.gate_nand(ck, chain[-1], cy))
    torch.cuda.synchronize()
    launches = cuda_rotate.blind_rotate_cuda.launches
    if cuda_rotate.blind_rotate_sel_cuda.launches:
        raise AssertionError("the single-key path launched the compact-key kernel")
    if out.a.shape != (MAIN_BATCH, fast.lwe_size) or out.a.dtype != torch.int32:
        raise AssertionError(f"gate output {out.a.dtype} {tuple(out.a.shape)}")
    if not torch.equal(api.decrypt(sk, out), x & y):
        raise AssertionError("bootsAND decrypts wrong")
    want = x
    for t in range(1, CHAIN + 1):
        want = ~(want & y)
        if not torch.equal(api.decrypt(sk, chain[t]), want):
            raise AssertionError(f"NAND chain decrypts wrong at step {t}")
    if launches != 1 + CHAIN:
        raise AssertionError(f"main path launched the kernel {launches} times, not {1 + CHAIN}")
    log("main path", f"tfhe_128_tpu_fast B={MAIN_BATCH}: bootsAND ({t_and:.3f} s) and a "
        f"{CHAIN}-NAND chain decrypt correctly; kernel launches {launches}")

    # 5. second geometry: tfhe_128_tpu (N=1024, k=1, l=3)
    l3 = P.tfhe_parameters_128_tpu()
    (sk3, ck3), t3_keygen = sync_time(lambda: api.make_key_pair(
        torch.Generator().manual_seed(SEED + 1), l3, device=dev))
    x3 = torch.from_numpy(rng.integers(0, 2, 64).astype(bool)).to(dev)
    y3 = torch.from_numpy(rng.integers(0, 2, 64).astype(bool)).to(dev)
    c3x, c3y = api.encrypt(gen, sk3, x3), api.encrypt(gen, sk3, y3)
    if not torch.equal(api.decrypt(sk3, gates.gate_and(ck3, c3x, c3y)), x3 & y3):
        raise AssertionError("tfhe_128_tpu bootsAND decrypts wrong")
    N3 = l3.rlwe_polynomial_degree
    t3 = c3x + c3y
    compare("tfhe_128_tpu full key", ck3.bootstrap_key.fb, bootstrap.bk_geometry(l3), l3.tgsw,
            rand_i32(rng, (64, l3.rlwe_mask_size + 1, N3)), decode_message(t3.a, 2 * N3),
            decode_message(t3.b, 2 * N3), gates.EIGHTH[1])
    log("tfhe_128_tpu", "B=64 bootsAND decrypts correctly")
    scan_routes = {}
    v1_launches = scan_route("tfhe_128_tpu", sk3, ck3, x3[:V1_BATCH["tfhe_128_tpu"]],
                             y3[:V1_BATCH["tfhe_128_tpu"]], gen, scan_routes)

    # 6. times (informational) and the kernel at the main path's shapes
    t = cx + cy + lwe_noiseless_trivial(gates.EIGHTH[-1], fast.lwe, (MAIN_BATCH,), device=dev)
    bara, barb = decode_message(t.a, 2 * N), decode_message(t.b, 2 * N)  # the AND's mod-switch
    rot_args = (geom, fast.bs_decomp_length, fast.bs_log2_base, fast.tgsw.offset)
    sv = (gates.EIGHTH[1], barb)
    plain_out, plain_s = sync_time(lambda: fblock.blind_rotate_fblock(None, ck.bootstrap_key.fb,
                                                                      bara, *rot_args, stepvec=sv))
    kern_out = cuda_rotate.blind_rotate_cuda(None, ck.bootstrap_key.fb, bara, *rot_args, stepvec=sv)
    max_err = max_diff(kern_out, plain_out)
    if max_err:
        raise AssertionError(f"kernel != plain at the main path's shapes: max |diff| {max_err}")
    log("kernel==plain", f"tfhe_128_tpu_fast full key B={MAIN_BATCH} stepvec: equal")
    # both init modes on the same work: the explicit accumulator is the test vector
    acc0 = fblock.stepvec_acc0(sv[0], barb, geom)
    modes = {"stepvec": (None, sv), "acc": (acc0, None)}
    times = {}
    for mode, (a, s) in modes.items():
        plain = event_ms(lambda: fblock.blind_rotate_fblock(a, ck.bootstrap_key.fb, bara,
                                                           *rot_args, stepvec=s), 3)
        kern = event_ms(lambda: cuda_rotate.blind_rotate_cuda(a, ck.bootstrap_key.fb, bara,
                                                             *rot_args, stepvec=s), 3)
        times[mode] = (kern, plain)
        log("rotate time", f"tfhe_128_tpu_fast B={MAIN_BATCH} {mode}: kernel {kern:.3f} ms, "
            f"plain {plain:.3f} ms (plain cold {plain_s:.3f} s)")
    ms, plain_ms = times["stepvec"]
    bound_ms, bound_by = cuda_rotate.rotate_bound_ms(MAIN_BATCH, geom, ck.bootstrap_key.fb.numel())
    plan = cuda_rotate.rotate_plan(MAIN_BATCH, geom, fast.bs_decomp_length,
                                   torch.cuda.get_device_properties(dev).multi_processor_count)
    log("rotate plan", f"B={MAIN_BATCH}: tile {plan.tile.bm} gates x {plan.tile.wq} coefficients, "
        f"{plan.tiles} tiles a step on a grid of {cuda_rotate.blind_rotate_cuda.grid} blocks "
        f"({plan.waves:.2f} rounds, {plan.fill:.3f} busy), {plan.smem_bytes} B shared memory a "
        f"block, {plan.scratch_bytes} B of digit scratch; bound {bound_ms:.3f} ms ({bound_by})")

    # two launches on two streams at once, half the batch each: the grid
    # barrier of one cannot wait on the other's, and the words are the same
    half = MAIN_BATCH // 2
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    halves = []
    for i, stream in enumerate(streams):
        stream.wait_stream(torch.cuda.current_stream(dev))
        rows = slice(i * half, (i + 1) * half)
        with torch.cuda.stream(stream):
            halves.append(cuda_rotate.blind_rotate_cuda(
                None, ck.bootstrap_key.fb, bara[rows], *rot_args, stepvec=(sv[0], barb[rows])))
    torch.cuda.synchronize()
    if not torch.equal(torch.cat(halves), kern_out):
        raise AssertionError("two launches on two streams != the one-stream words")
    log("two streams", f"2 x B={half} on two streams at once finish and equal the B={MAIN_BATCH} "
        "launch word for word")

    # yardstick, partial: the one torch._int_mm a plain step calls, n times.
    # It is the contraction alone (no rotate, digits or shift-add), over the
    # plain version's zero-padded K = R*D*bs; the port's path never calls it.
    gy = torch.Generator(device=dev).manual_seed(SEED)
    dexp = torch.randint(-128, 128, (MAIN_BATCH * geom.nb, geom.R * geom.D * geom.bs),
                         generator=gy, dtype=torch.int8, device=dev)
    fmat_t = torch.randint(-128, 128, (len(geom.cols) * geom.bs, geom.R * geom.D * geom.bs),
                           generator=gy, dtype=torch.int8, device=dev)
    mm_ms = event_ms(lambda: torch._int_mm(dexp, fmat_t.t()), 20)
    log("yardstick (partial)", f"{geom.n} x one torch._int_mm {tuple(dexp.shape)} @ "
        f"{tuple(fmat_t.t().shape)} = {geom.n} x {mm_ms:.4f} ms = {geom.n * mm_ms:.3f} ms "
        f"(contraction only; kernel {ms:.3f} ms, bound {bound_ms:.3f} ms)")
    del dexp, fmat_t, halves
    gate_s = [sync_time(lambda: gates.gate_and(ck, cx, cy))[1] for _ in range(3)]
    c1x, c1y = api.encrypt(gen, sk, x[:1]), api.encrypt(gen, sk, y[:1])
    lat = [sync_time(lambda: gates.gate_and(ck, c1x, c1y))[1] for _ in range(11)]
    log("times", f"keygen {t_keygen:.2f} s, F-block build {t_fb:.2f} s; bootsAND B={MAIN_BATCH}: "
        f"{MAIN_BATCH / statistics.mean(gate_s):.1f} gates/s through the kernel; plain blind "
        f"rotate {MAIN_BATCH / (plain_ms / 1e3):.1f} rotations/s, kernel blind rotate "
        f"{MAIN_BATCH / (ms / 1e3):.1f} rotations/s; p50 bootsAND latency B=1 "
        f"{statistics.median(lat) * 1e3:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # N5, which is B3: tools/profile_trace on this key; the split holds the keyswitch too
    torch.cuda.reset_peak_memory_stats()
    s5, n_launches = profile_phase(f"N5/B3 tfhe_128_tpu_fast bootsAND B={MAIN_BATCH}",
                                   "blind_rotate (expanded key)",
                                   lambda: gates.gate_and(ck, cx, cy))
    if n_launches != {"blind_rotate": 1 + s5["traces"], "blind_rotate_sel": 0}:
        raise AssertionError(f"N5/B3: launches {n_launches}, want {1 + s5['traces']} of "
                             "blind_rotate (one untraced call, one a trace)")
    if "int8 GEMM" not in s5["by_category"]:
        raise AssertionError(f"N5/B3: no keyswitch int8 GEMM in {s5['by_category']}")

    # B1-B3: the main path's measurement tools, tools/{bench,profile,profile_trace}.py
    b_launches = bench_phase("tfhe_128_tpu_fast", sk, ck, t_keygen)
    b_launches += bench_phase("tfhe_128_tpu", sk3, ck3, t3_keygen)
    del sk3, ck3, c3x, c3y, t3
    torch.cuda.empty_cache()
    n, b2_err, latency = profile_table(dev)
    b_launches += n

    # P4: the batch-sharded bootsAND over two mesh slots == the single-device one
    from torus_fhe_tpu_torch.parallel import make_mesh
    from torus_fhe_tpu_torch.parallel import mesh as pmesh

    bmesh = make_mesh(n_batch=2, devices=mesh_devices(2))
    keys_by_dev = pmesh.replicate_cloud_key(ck, bmesh)
    xs, ys = pmesh.shard_lwe_batch(cx, bmesh), pmesh.shard_lwe_batch(cy, bmesh)
    torch.cuda.synchronize()
    reset_launches(cuda_rotate)
    sh_out, t_sh = sync_time(lambda: pmesh.run_batch_sharded(gates.gate_and, keys_by_dev, xs, ys,
                                                             mesh=bmesh))
    sh_launches = cuda_rotate.blind_rotate_cuda.launches
    if sh_launches != 2 or cuda_rotate.blind_rotate_sel_cuda.launches:
        raise AssertionError(f"batch-sharded gate launched blind_rotate {sh_launches}x, not 2")
    if not (torch.equal(sh_out.a, out.a) and torch.equal(sh_out.b, out.b)):
        raise AssertionError("batch-sharded gate_and != single-device gate_and")
    if not torch.equal(api.decrypt(sk, sh_out), x & y):
        raise AssertionError("batch-sharded gate_and decrypts wrong")
    sh_s = [sync_time(lambda: pmesh.run_batch_sharded(gates.gate_and, keys_by_dev, xs, ys,
                                                      mesh=bmesh))[1] for _ in range(3)]
    log("P4 batch-sharded", f"tfhe_128_tpu_fast B={MAIN_BATCH} over 2 slots on "
        f"{sorted({str(d) for d in bmesh.batch_devices()})}: == single-device gate_and word "
        f"for word, decrypts; blind_rotate launched {sh_launches}x; {t_sh:.3f} s cold, "
        f"{MAIN_BATCH / statistics.mean(sh_s):.1f} gates/s (single device "
        f"{MAIN_BATCH / statistics.mean(gate_s):.1f})")

    # P5's inputs: the fast set's cloud key file and the single-device gate's words
    from torus_fhe_tpu_torch.utils import serialize

    p5_dir = tempfile.TemporaryDirectory(prefix="p5_")
    serialize.save_cloud_key(os.path.join(p5_dir.name, "fast_cloud.key"), ck)
    np.savez(os.path.join(p5_dir.name, "gate.npz"), x_a=cx.a.cpu(), x_b=cx.b.cpu(),
             y_a=cy.a.cpu(), y_b=cy.b.cpu(), out_a=out.a.cpu(), out_b=out.b.cpu())

    # S1: the fast set's key files, saved, loaded back onto the card, same gate words

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("secret.key", "cloud.key")]
        _, t_save = sync_time(lambda: (serialize.save_secret_key(paths[0], sk),
                                       serialize.save_cloud_key(paths[1], ck)))
        size = sum(os.path.getsize(f) for f in paths)
        (sk2, ck2), t_load = sync_time(lambda: (serialize.load_secret_key(paths[0]),
                                                serialize.load_cloud_key(paths[1])))
    if sk2.key.key.device.type != dev.type or ck2.bootstrap_key.fb.device.type != dev.type:
        raise AssertionError("S1: loaded keys are not on the card")
    if ck2.params != fast or not torch.equal(ck2.bootstrap_key.fb, ck.bootstrap_key.fb):
        raise AssertionError("S1: the loaded cloud key differs from the saved one")
    out2 = gates.gate_and(ck2, cx, cy)
    if not (torch.equal(out2.a, out.a) and torch.equal(out2.b, out.b)):
        raise AssertionError("S1: gate_and on the loaded key != on the saved key")
    if not torch.equal(api.decrypt(sk2, out2), x & y):
        raise AssertionError("S1: the loaded secret key decrypts wrong")
    log("S1 key files", f"tfhe_128_tpu_fast secret + cloud key: {size / 1e6:.1f} MB on disk, saved "
        f"in {t_save:.2f} s, loaded onto the card in {t_load:.2f} s; gate_and on the loaded key "
        f"== on the saved key word for word (B={MAIN_BATCH}), decrypts")
    del sk2, ck2, out2

    B1 = V1_BATCH["tfhe_128_tpu_fast"]
    v1_launches += scan_route("tfhe_128_tpu_fast", sk, ck, x[:B1], y[:B1], gen, scan_routes)
    single_key_circuits(sk, ck, gen, rng)
    aux_launches = threshold_aux(sk, ck, gen, rng, dev)

    del sk, ck, cx, cy, c1x, c1y, chain, out, plain_out, kern_out, acc0, t, bara, barb, sv
    del keys_by_dev, xs, ys, sh_out
    torch.cuda.empty_cache()

    aux_launches += cli_phase(rng)
    mkr = multikey(dev, rng)
    pipe = pipelines(rng, mkr.pop("kept"), p5_dir.name)
    sharded_ops(rng, p5_dir.name)
    p5 = mesh_across_processes(p5_dir.name, pipe["pipe_ms"])
    p5_dir.cleanup()
    routes = wide_route(dev, rng)
    routes.update(scan_routes)
    routes.update(scheme_phases(dev, rng))
    routes.update(multiparty_schemes(dev, rng))
    routes.update(native_phase(dev))
    for phase in (noise_single_key, noise_3gen_public, exact_route, mk_knn_phase):
        for k, n in phase(dev, rng, routes).items():
            n_launches[k] += n

    circ = {k: sum(rec["launches"][k] for rec in CIRCUITS.values())
            for k in ("blind_rotate", "blind_rotate_sel")}
    print(json.dumps({"circuits": CIRCUITS}))
    print(json.dumps({"threshold_aux": AUX}))
    print(json.dumps({"kernels": [
        {"name": "blind_rotate", "route": "cuda",
         "source": "torus_fhe_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "torus_fhe_tpu/ops/pallas_rotate.py:264",
         "launches": launches + sh_launches + mkr["launches"]["blind_rotate"]
         + pipe["launches"]["blind_rotate"] + circ["blind_rotate"] + aux_launches
         + n_launches["blind_rotate"] + p5["blind_rotate"] + v1_launches + b_launches,
         "max_abs_err": max(max_err, mkr["err"]["blind_rotate"], pipe["err"]["blind_rotate"],
                            b2_err),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None},
        {"name": "blind_rotate_sel", "route": "cuda",
         "source": "torus_fhe_tpu_torch/csrc/blind_rotate_sel.cu",
         "replaces": "torus_fhe_tpu/ops/fblock.py:339, torus_fhe_tpu/parallel/mk_pipeline.py:184",
         "launches": mkr["launches"]["blind_rotate_sel"] + pipe["launches"]["blind_rotate_sel"]
         + circ["blind_rotate_sel"] + n_launches["blind_rotate_sel"] + p5["blind_rotate_sel"],
         "max_abs_err": max(mkr["err"]["blind_rotate_sel"], pipe["err"]["blind_rotate_sel"]),
         "ms": mkr["ms"]["blind_rotate_sel"],
         "plain_ms": mkr["plain_ms"]["blind_rotate_sel"],
         "bound_ms": mkr["bound_ms"]["blind_rotate_sel"][0],
         "bound_by": mkr["bound_ms"]["blind_rotate_sel"][1], "library_ms": None},
        {"name": "blind_rotate", "tile": "latency", "route": "cuda",
         "source": "torus_fhe_tpu_torch/csrc/rotate_latency.cuh",
         "replaces": "torus_fhe_tpu/ops/pallas_rotate.py:264", **latency}]}))
    print(json.dumps({"routes": routes}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def bench_phase(name: str, sk, ck, keygen_s: float) -> int:
    """B1: tools/bench.measure on a key held here at BENCH_BATCH[name]
    gates, with the counts at 0 before it and read after: the decrypt checks
    of the AND and the NAND chain, the rates, the p50 at B=1, and exactly
    BENCH_LAUNCHES launches of blind_rotate, BENCH_TIMED of them in the
    timed windows. Prints the tool's JSON line with a ``bench`` tag;
    returns the launches."""
    from torus_fhe_tpu_torch.tools import bench

    B = BENCH_BATCH[name]
    torch.cuda.reset_peak_memory_stats()
    (rec, _), counts, wall = launched(lambda: bench.measure(sk, ck, *bench.inputs(B)))
    tag = "fast" if name == "tfhe_128_tpu_fast" else "l3"
    print(json.dumps({"bench": f"B1 {name} B={B}",
                      **bench.result(rec, tag, DEVICE, keygen_s, "keygen (smoke)")}), flush=True)
    want = {"blind_rotate": BENCH_LAUNCHES, "blind_rotate_sel": 0}
    if counts != want or rec["kernel_launches"] != BENCH_TIMED:
        raise AssertionError(f"B1 {name}: launches {counts} ({rec['kernel_launches']} timed), "
                             f"want {want} ({BENCH_TIMED} timed)")
    log(f"B1 bench {name}", f"B={B}: AND and {rec['chain_len']}-NAND chain decrypt; chained "
        f"{rec['chained_gates_per_s']:.1f} gates/s, dispatched {rec['dispatched_gates_per_s']:.1f}"
        f", p50 B=1 {rec['p50_single_bootstrap_ms']:.3f} ms, first call {rec['compile_s']:.3f} s;"
        f" {counts['blind_rotate']} launches; {wall:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{SMI}]")
    return counts["blind_rotate"]


def profile_table(dev) -> tuple:
    """B2: tools/profile's table at PROFILE_SET on a key of its own (the
    first run of that set on the card), freed after: the full key's kernel
    against its plain version on one mod-switched AND batch (word for word,
    timed, beside the bound from shapes), then the rows with the counts at
    0 before them and read after (exactly PROFILE_LAUNCHES launches of
    blind_rotate; the adder's words decrypt-checked inside). Between the
    two, the latency tile on the same key at LATENCY_CHECK gates, both init
    modes, word for word, and one gate timed beside its bound. Returns (the
    rows' launches, the kernel's max |diff|, the latency tile's entry of
    the kernels line: its launches here, max |diff|, ms, plain ms, bound)."""
    from torus_fhe_tpu_torch.boot import api, bootstrap, gates
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.core.torus import decode_message
    from torus_fhe_tpu_torch.lwe import lwe_noiseless_trivial
    from torus_fhe_tpu_torch.ops import cuda_rotate, fblock
    from torus_fhe_tpu_torch.tools import profile

    name, B, iters = PROFILE_SET
    params = P.PARAMETER_REGISTRY[name]()
    torch.cuda.reset_peak_memory_stats()
    sk, ck, keygen_s = profile.make_keys(params, dev)
    fb, geom = ck.bootstrap_key.fb, bootstrap.bk_geometry(params)
    gen, rng = torch.Generator().manual_seed(SEED + 7), np.random.default_rng(SEED + 7)
    cx, cy = (api.encrypt(gen, sk, torch.from_numpy(rng.integers(0, 2, B) == 1)) for _ in range(2))
    t = cx + cy + lwe_noiseless_trivial(gates.EIGHTH[-1], params.lwe, (B,), device=dev)
    N2 = 2 * params.rlwe_polynomial_degree
    bara, sv = decode_message(t.a, N2), (gates.EIGHTH[1], decode_message(t.b, N2))
    args = (geom, params.bs_decomp_length, params.bs_log2_base, params.tgsw.offset)
    plain, plain_s = sync_time(lambda: fblock.blind_rotate_fblock(None, fb, bara, *args,
                                                                  stepvec=sv))
    err = max_diff(cuda_rotate.blind_rotate_cuda(None, fb, bara, *args, stepvec=sv), plain)
    if err:
        raise AssertionError(f"B2 {name}: kernel != plain on the full key: max |diff| {err}")
    ms = event_ms(lambda: cuda_rotate.blind_rotate_cuda(None, fb, bara, *args, stepvec=sv), 3)
    bound, bound_by = cuda_rotate.rotate_bound_ms(B, geom, fb.numel())
    log(f"B2 {name}", f"keygen {keygen_s:.2f} s, fb {tuple(fb.shape)} = {fb.numel() / 1e9:.2f} GB"
        f" ({len(geom.cols)} limb columns); kernel == plain on the full key B={B} stepvec; kernel"
        f" {ms:.3f} ms, plain {plain_s * 1e3:.1f} ms cold, bound {bound:.3f} ms ({bound_by})")
    by_config = cuda_rotate.blind_rotate_cuda.by_config
    before = by_config.get(cuda_rotate.LATENCY_CONFIG, 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plain_ms = {}
    for Bl in LATENCY_CHECK:
        if cuda_rotate.rotate_plan(Bl, geom, params.bs_decomp_length, sms).latency is None:
            raise AssertionError(f"B2 {name}: B={Bl} does not take the latency tile")
        sv_l = (sv[0], sv[1][:Bl].contiguous())
        for mode, a, s in (("acc", rand_i32(rng, (Bl, geom.C, geom.N)), None),
                           ("stepvec", None, sv_l)):
            want, plain_s = sync_time(lambda: fblock.blind_rotate_fblock(
                a, fb, bara[:Bl].contiguous(), *args, stepvec=s))
            plain_ms[Bl, mode] = plain_s * 1e3
            e = max_diff(cuda_rotate.blind_rotate_cuda(a, fb, bara[:Bl].contiguous(), *args,
                                                       stepvec=s), want)
            if e:
                raise AssertionError(f"B2 {name}: latency tile != plain on the full key, B={Bl} "
                                     f"{mode}: max |diff| {e}")
    one = (sv[0], sv[1][:1].contiguous())
    ms_l = event_ms(lambda: cuda_rotate.blind_rotate_cuda(None, fb, bara[:1].contiguous(), *args,
                                                          stepvec=one), 3)
    bound_l, by_l = cuda_rotate.rotate_bound_ms(1, geom, fb.numel())
    latency = {"launches": by_config.get(cuda_rotate.LATENCY_CONFIG, 0) - before,
               "max_abs_err": 0, "ms": ms_l, "plain_ms": plain_ms[1, "stepvec"],
               "bound_ms": bound_l, "bound_by": by_l, "library_ms": None}
    if latency["launches"] != 2 * len(LATENCY_CHECK) + 4:
        raise AssertionError(f"B2 {name}: {latency['launches']} launches of the latency tile, "
                             f"want {2 * len(LATENCY_CHECK) + 4}")
    log(f"B2 {name}", f"latency tile == plain on the full key at B in {LATENCY_CHECK}, both modes"
        f"; B=1 kernel {ms_l:.3f} ms, plain {plain_ms[1, 'stepvec']:.1f} ms, bound "
        f"{bound_l:.3f} ms ({by_l}); {latency['launches']} launches")
    del plain, t, bara, sv, cx, cy
    (rows, _), counts, wall = launched(lambda: profile.measure(sk, ck, B, iters))
    print(profile.table(f"# device={SMI} params={name} batch={B}",
                        [("keygen(sk+bk+ksk)", keygen_s, 1 / keygen_s)] + rows), flush=True)
    want = {"blind_rotate": PROFILE_LAUNCHES, "blind_rotate_sel": 0}
    if counts != want:
        raise AssertionError(f"B2 {name}: launches {counts}, want {want}")
    log(f"B2 {name}", f"{len(rows) + 1} rows, adder words decrypt; {counts['blind_rotate']} "
        f"launches; {wall:.1f} s; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{SMI}]")
    del sk, ck, fb
    torch.cuda.empty_cache()
    return counts["blind_rotate"], err, latency


def mesh_devices(k: int) -> list:
    """k mesh slots over the cards there are: slot i on cuda:(i % count),
    so on one card every slot is a stream of cuda:0."""
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(k)]


def reset_launches(cuda_rotate) -> None:
    for wrapper in (cuda_rotate.blind_rotate_cuda, cuda_rotate.blind_rotate_sel_cuda):
        wrapper.launches = wrapper.rows = 0


def max_diff(got, want) -> int:
    torch.cuda.synchronize()
    return (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()


def multikey(dev, rng) -> dict:
    """The 3gen multikey phases. Returns the kernels' launch counts over the
    multikey main paths, their largest differences from the plain versions,
    the compact kernel's times and bound at its main shape (the 8-party set),
    and the keys of the pipelined sets
    (``kept``: params, party keys, and the cloud key with its raw samples
    and without its rotate forms)."""
    import dataclasses

    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.core.torus import decode_message
    from torus_fhe_tpu_torch.mk import boot3gen, gates3gen, keys3gen
    from torus_fhe_tpu_torch.ops import cuda_rotate, fblock
    from torus_fhe_tpu_torch.tools import perf_comp

    names = ("blind_rotate", "blind_rotate_sel")
    res = {"launches": dict.fromkeys(names, 0), "err": dict.fromkeys(names, 0),
           "ms": {}, "plain_ms": {}, "bound_ms": {}, "kept": {}}

    def rot_args(params, parties):
        tg = P.TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 32)
        return (keys3gen.mk_fb_geometry(params, parties), tg.decomp_length, tg.log2_base,
                tg.offset)

    def check(tag, kernel, got, want):
        err = max_diff(got, want)
        res["err"][kernel] = max(res["err"][kernel], err)
        if err:
            raise AssertionError(f"{kernel} != reference at {tag}: max |diff| {err}")

    # M1. compact kernel == plain blind_rotate_streamed at small geometries, 42 steps
    for N in (64, 256):
        for l, lb in ((2, 7), (3, 6), (4, 4)):
            params = P.SchemeParams3Gen(**{**P.test_parameters_3gen(2, 21, N).__dict__,
                                           "gsw_decomp_length": l, "gsw_log2_base": lb})
            g = torch.Generator().manual_seed(SEED)
            sks = [mk.mk_party_keygen(g, params) for _ in range(2)]
            sel = mk.mk_cloud_keygen(g, sks, params, device=dev, forms=("fbstream",)).bk_fb_sel
            args = rot_args(params, 2)
            for B in SEL_RAGGED:
                acc, barb = rand_i32(rng, (B, 2, N)), rand_i32(rng, (B,), -N, N)
                bara = rand_i32(rng, (B, sel.shape[0]), 0, 2 * N)
                for mode, a, sv in (("acc", acc, None), ("stepvec", None, (1 << 29, barb))):
                    check(f"N={N} l={l} B={B} {mode}", "blind_rotate_sel",
                          cuda_rotate.blind_rotate_sel_cuda(a, sel, bara, *args, stepvec=sv),
                          fblock.blind_rotate_streamed(a, sel, bara, *args, stepvec=sv))
            log("compact==plain", f"N={N} l={l} Bg=2^{lb}: {sel.shape[0]} steps, B in "
                f"{SEL_RAGGED}, both modes equal")

    for name, parties, B in MK_SETS:
        params = P.PARAMETER_REGISTRY[name]()
        forms = keys3gen.default_forms(params, parties)
        if forms == ("fblock",):  # the compact form too: both kernels on one key
            forms = ("fblock", "fbstream")
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator().manual_seed(SEED + parties)
        t0 = time.perf_counter()
        sks = [mk.mk_party_keygen(gen, params, device=dev) for _ in range(parties)]
        ck = mk.mk_cloud_keygen(gen, sks, params, device=dev, forms=forms,
                                keep_samples=name in PIPE_BATCH or name == S1_MK_SET)
        torch.cuda.synchronize()
        t_keygen = time.perf_counter() - t0
        keys = [sk.lwe for sk in sks]
        main_ck = dataclasses.replace(ck, bk_fb_sel=None) if ck.bk_fb is not None else ck
        kernel = "blind_rotate" if main_ck.bk_fb is not None else "blind_rotate_sel"
        msgs = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        ys = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        ct, cy = mk.mk_encrypt(gen, keys, msgs, params), mk.mk_encrypt(gen, keys, ys, params)
        ct_true = mk.mk_encrypt(gen, keys, torch.ones(B, dtype=torch.bool, device=dev), params)
        chain_len = CHAIN if parties == 2 else 1

        # the main path: AND(m, 1) = m, then a NAND chain x_{t+1} = NAND(x_t, y)
        torch.cuda.synchronize()
        reset_launches(cuda_rotate)
        out, t_and = sync_time(lambda: gates3gen.mk_gate_and(main_ck, ct, ct_true))
        chain = [out]
        for _ in range(chain_len):
            chain.append(gates3gen.mk_gate_nand(main_ck, chain[-1], cy))
        torch.cuda.synchronize()
        counts = {"blind_rotate": cuda_rotate.blind_rotate_cuda.launches,
                  "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda.launches}
        peak = torch.cuda.max_memory_allocated()
        other = names[1 - names.index(kernel)]
        if counts[kernel] != 1 + chain_len or counts[other]:
            raise AssertionError(f"{name}: launches {counts}, want {1 + chain_len} of {kernel} "
                                 f"and none of {other}")
        res["launches"][kernel] += counts[kernel]
        if out.a.shape != (B, parties, params.lwe_size) or out.a.dtype != torch.int32:
            raise AssertionError(f"{name}: gate output {out.a.dtype} {tuple(out.a.shape)}")
        want, wrong = msgs, int(mk.mk_decrypt(keys, out).ne(msgs).sum())
        for step in range(1, chain_len + 1):
            want = ~(want & ys)
            wrong += int(mk.mk_decrypt(keys, chain[step]).ne(want).sum())
        if wrong:
            raise AssertionError(f"{name}: {wrong} wrong decryptions")
        log(f"mk {name}", f"{'+'.join(forms)} key, B={B}: AND and {chain_len} NAND decrypt "
            f"correctly (0 wrong of {B * (1 + chain_len)}); {kernel} launched {counts[kernel]}x, "
            f"{other} 0x; keygen {t_keygen:.2f} s, AND {t_and:.3f} s = {B / t_and:.1f} gates/s; "
            f"peak memory {peak / 1e9:.2f} GB")
        # N2: the noise, through the harness's report step on this key
        n2 = noise_3gen(name, sks, main_ck, gen, rng, dev)
        want = 3
        if parties == 8:
            s5, n5 = profile_phase(f"N5 {name} AND B={B}", "blind_rotate_sel (compact key)",
                                   lambda: gates3gen.mk_gate_and(main_ck, ct, ct_true))
            n2 = {k: n2[k] + n5[k] for k in names}
            want += 1 + s5["traces"]
        if n2[other] or n2[kernel] != want:
            raise AssertionError(f"{name} N2/N5: launches {n2}, want {want} of {kernel} (N5: "
                                 "one untraced call, one a trace)")
        res["launches"][kernel] += n2[kernel]
        # tools/perf_comp's 3gen row on this key: one NAND, decrypt-checked, its kernel once
        prow = perf_comp.row("3gen", main_ck, sks, B, 1, SEED + 800 + parties, warmup=False)
        if not (prow["correct"] and prow["noise_ok"]):
            raise AssertionError(f"perf_comp row {name}: {'; '.join(prow['fails'])}")
        res["launches"][kernel] += prow["launches"][kernel]
        log(f"perf_comp row {name}", f"NAND B={B}: {prow['min_s']:.3f} s = "
            f"{prow['gates_per_s']:.1f} gates/s, {prow['wrong']} wrong, std "
            f"{prow['boot_noise_std']:.5f}; {kernel} {prow['launches'][kernel]}x; key "
            f"{prow['key_bytes']} B; bound {prow['bound_ms']:.2f} ms ({prow['bound_by']})")
        print(json.dumps({"perf_comp": {name: prow}}), flush=True)
        if parties * params.lwe_size == TAIL_RING:  # the tail on a ring above 4,096
            from torus_fhe_tpu_torch.apps import mk_knn

            for bit in (False, True):  # one output of each value, so a constant tail fails
                i = int(torch.nonzero(msgs.cpu() == bit)[0])
                one = mk.MKLweSample(out.a[i], out.b[i])
                tail = circuit_phase(
                    f"T8 mk_threshold_tail (ring {TAIL_RING}, FFT product), {name}, bit {int(bit)}",
                    None, lambda: mk_knn.mk_threshold_tail(
                        one, keys, torch.Generator().manual_seed(SEED + 13)))
                expect(f"T8 mk_threshold_tail, {name}, bit {int(bit)}", [r["bit"] for r in tail],
                       [int(bit)] * len(tail))
                if len(tail) != 4:
                    raise AssertionError(f"T8: {len(tail)} bounds, want 4")

        if name == S1_MK_SET:  # S1: this key's file, saved, loaded onto the card, same words
            save_load_mk_key(ck, lambda k: gates3gen.mk_gate_and(k, ct, ct_true), out, name, B)

        # the kernels at this set's shapes: the AND's rotate, stepvec mode
        t = gates3gen.mk_gate_and_wb(main_ck, ct, ct_true)
        N = params.rlwe_polynomial_degree
        bara = decode_message(t.a, 2 * N).reshape(B, -1)
        sv = (boot3gen.hi_word(gates3gen.MU), decode_message(t.b, 2 * N))
        args = rot_args(params, parties)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if parties == 8:  # the real key's first 16 steps at ragged batches, both init modes
            sel16, args16 = ck.bk_fb_sel[:16], (args[0]._replace(n=16),) + args[1:]
            for Br in RAGGED + (STAGE_BATCH,):
                acc, barb = rand_i32(rng, (Br, 2, N)), rand_i32(rng, (Br,), -N, N)
                bara16 = rand_i32(rng, (Br, 16), 0, 2 * N)
                for mode, a, s in (("acc", acc, None), ("stepvec", None, (sv[0], barb))):
                    check(f"{name} key, first 16 steps, B={Br} {mode}", "blind_rotate_sel",
                          cuda_rotate.blind_rotate_sel_cuda(a, sel16, bara16, *args16, stepvec=s),
                          fblock.blind_rotate_streamed(a, sel16, bara16, *args16, stepvec=s,
                                                       chunk=16))
            log("compact==plain", f"{name} key, first 16 steps: B in {RAGGED + (STAGE_BATCH,)}, "
                "both modes equal")
        compact = cuda_rotate.blind_rotate_sel_cuda(None, ck.bk_fb_sel, bara, *args, stepvec=sv)
        # each plain version runs once: its check is its timing
        plain_out, plain_ms = event_once(lambda: fblock.blind_rotate_streamed(
            None, ck.bk_fb_sel, bara, *args, stepvec=sv))
        check(f"{name} B={B}", "blind_rotate_sel", compact, plain_out)
        times = {"blind_rotate_sel": (
            event_ms(lambda: cuda_rotate.blind_rotate_sel_cuda(None, ck.bk_fb_sel, bara, *args,
                                                               stepvec=sv), 3), plain_ms)}
        plan = cuda_rotate.sel_plan(B, args[0], args[1], sms)
        log(f"rotate plan {name}", f"blind_rotate_sel B={B}: tile {plan.tile.bm} gates x "
            f"{plan.tile.wq} coefficients, {plan.tiles} tiles a step on a grid of "
            f"{cuda_rotate.blind_rotate_sel_cuda.grid} blocks ({plan.waves:.2f} rounds, "
            f"{plan.fill:.3f} busy), {plan.smem_bytes} B shared memory a block; key "
            f"{ck.bk_fb_sel.numel() / 1e6:.1f} MB {tuple(ck.bk_fb_sel.shape)}")
        if ck.bk_fb is not None:
            check(f"{name} B={B}, expanded vs compact", "blind_rotate",
                  cuda_rotate.blind_rotate_cuda(None, ck.bk_fb, bara, *args, stepvec=sv), compact)
            times["blind_rotate"] = (
                event_ms(lambda: cuda_rotate.blind_rotate_cuda(None, ck.bk_fb, bara, *args,
                                                               stepvec=sv), 3),
                event_once(lambda: fblock.blind_rotate_fblock(None, ck.bk_fb, bara, *args,
                                                              stepvec=sv))[1])
        else:  # one gate's latency through the compact kernel
            one_ms = event_ms(lambda: cuda_rotate.blind_rotate_sel_cuda(
                None, ck.bk_fb_sel, bara[:1], *args, stepvec=(sv[0], sv[1][:1])), 3)
            one, one_true = type(ct)(ct.a[:1], ct.b[:1]), type(ct)(ct_true.a[:1], ct_true.b[:1])
            lat = [sync_time(lambda: gates3gen.mk_gate_and(main_ck, one, one_true))[1]
                   for _ in range(5)]
            log(f"rotate time {name}", f"B=1 stepvec, {bara.shape[1]} steps: blind_rotate_sel "
                f"{one_ms:.3f} ms; p50 mk_gate_and latency B=1 "
                f"{statistics.median(lat) * 1e3:.2f} ms")
        for kname, (ms, plain_ms) in times.items():
            log(f"rotate time {name}", f"B={B} stepvec, {bara.shape[1]} steps: {kname} "
                f"{ms:.3f} ms, its plain version {plain_ms:.3f} ms (equal words)")
            if MAIN_SHAPE[kname] == name:
                res["ms"][kname], res["plain_ms"][kname] = ms, plain_ms
                res["bound_ms"][kname] = cuda_rotate.rotate_bound_ms(B, args[0], ck.bk_fb_sel.numel())
        if name in M1_SETS:  # M1-M3: the circuits over this set's key, on its kernel
            mk_circuits(name, params, sks, main_ck, kernel, rng)
        if name in PIPE_BATCH:  # for the pipelined phases: the raw samples and the tables
            res["kept"][name] = (params, sks, dataclasses.replace(ck, bk_fb=None, bk_fb_sel=None))
        del sks, ck, main_ck, ct, cy, ct_true, out, chain, t, bara, sv, compact, plain_out
        torch.cuda.empty_cache()
    return res


def pipelines(rng, kept: dict, p5_dir: str) -> dict:
    """The party-pipelined multikey rotate at full width, per set of
    PIPE_BATCH: P1, one party's stage, kernel == plain, explicit
    accumulator; P2 (8 parties, compact key) and P3 (2 parties, expanded
    key), the pipelined rotate == the single-call kernel over all steps ==
    the plain version stage by stage, then the main path
    mk_bootstrap_pipelined -> NAND -> decrypt, with its launches counted,
    word-equal to the single-device mk_gate_nand. P4's multikey keyswitch:
    party-sharded == single, at 8 parties. Writes P5's inputs to p5_dir:
    per set the raw samples, the keyswitch tables, the party LWE keys, the
    NAND batch, the pipelined accumulators and the NAND's words. Returns the
    launch counts of the main paths, the largest differences and the
    pipelined rotate's median ms per set."""
    import dataclasses
    import os

    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.core.torus import decode_message
    from torus_fhe_tpu_torch.lwe import LweSample
    from torus_fhe_tpu_torch.mk import boot3gen, gates3gen, keys3gen
    from torus_fhe_tpu_torch.ops import cuda_rotate, fblock
    from torus_fhe_tpu_torch.parallel import make_mesh, mk_pipeline, sharded
    from torus_fhe_tpu_torch.rlwe import RLweSample, rlwe_extract_sample

    names = ("blind_rotate", "blind_rotate_sel")
    res = {"launches": dict.fromkeys(names, 0), "err": dict.fromkeys(names, 0), "pipe_ms": {}}
    M = MICROBATCHES

    def check(tag, kernel, got, want):
        err = max_diff(got, want)
        res["err"][kernel] = max(res["err"][kernel], err)
        if err:
            raise AssertionError(f"{kernel} != reference at {tag}: max |diff| {err}")

    for name, B in PIPE_BATCH.items():
        params, sks, ck = kept.pop(name)
        parties, n, N = ck.parties, params.lwe_size, params.rlwe_polynomial_degree
        expanded = PIPE_FORM[name] == "expanded"
        kernel, other = names if expanded else names[::-1]
        wrapper = cuda_rotate.blind_rotate_cuda if expanded else cuda_rotate.blind_rotate_sel_cuda
        plain = fblock.blind_rotate_fblock if expanded else fblock.blind_rotate_streamed
        build = mk_pipeline.build_sharded_mk_fb if expanded else mk_pipeline.build_sharded_mk_sel
        tg = P.TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 32)
        tga = (tg.decomp_length, tg.log2_base, tg.offset)
        stage_args = (keys3gen.mk_fb_geometry(params, 1),) + tga
        full_args = (keys3gen.mk_fb_geometry(params, parties),) + tga
        mesh = make_mesh(n_batch=1, n_party=parties, devices=mesh_devices(parties))
        torch.cuda.reset_peak_memory_stats()
        shards, t_build = sync_time(lambda: build(ck.bk_samples, params, parties, mesh))

        # P1: one party's stage, explicit accumulator, kernel == plain
        acc = rand_i32(rng, (STAGE_BATCH, 2, N))
        bara_s = rand_i32(rng, (STAGE_BATCH, n), 0, 2 * N)
        last = shards[-1]
        stage_want, stage_plain = event_once(lambda: plain(acc, last, bara_s, *stage_args))
        check(f"{name} stage B={STAGE_BATCH} acc", kernel,
              wrapper(acc, last, bara_s, *stage_args), stage_want)
        stage_ms = event_ms(lambda: wrapper(acc, last, bara_s, *stage_args), 3)
        log(f"P1 {name}", f"{kernel} == plain, one {n}-step {PIPE_FORM[name]} stage, "
            f"B={STAGE_BATCH}, explicit accumulator; kernel {stage_ms:.3f} ms, plain "
            f"{stage_plain:.3f} ms; sharded key {sum(s.numel() for s in shards) / 1e9:.3f} GB "
            f"built in {t_build:.2f} s")

        # P2 / P3: a NAND batch; the pipelined rotate against the single call
        keys = [sk.lwe for sk in sks]
        x = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(DEVICE)
        y = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(DEVICE)
        gen = torch.Generator().manual_seed(SEED + 10 * parties)
        cx, cy = mk.mk_encrypt(gen, keys, x, params), mk.mk_encrypt(gen, keys, y, params)
        t = gates3gen.mk_gate_nand_wb(ck, cx, cy)
        bara = decode_message(t.a, 2 * N).reshape(B, parties, n)
        barb = decode_message(t.b, 2 * N)
        mu32 = boot3gen.hi_word(gates3gen.MU)
        full_key = torch.cat(shards)

        def single():
            return wrapper(None, full_key, bara.reshape(B, -1), *full_args, stepvec=(mu32, barb))

        def pipelined():
            return mk_pipeline.mk_blind_rotate_pipelined(shards, bara, barb, mu32, params,
                                                         parties, mesh, M)

        def plain_stages():
            """The same chain with the plain version, one call per stage."""
            Bm, outs = B // M, []
            for m in range(M):
                rows = slice(m * Bm, (m + 1) * Bm)
                a = plain(None, shards[0], bara[rows, 0].contiguous(), *stage_args,
                          stepvec=(mu32, barb[rows]))
                for p in range(1, parties):
                    a = plain(a, shards[p], bara[rows, p].contiguous(), *stage_args)
                outs.append(a)
            return torch.cat(outs)

        pipe = pipelined()
        check(f"{name} B={B} M={M} pipelined vs single call", kernel, pipe, single())
        plain_out, plain_s = sync_time(plain_stages)
        check(f"{name} B={B} M={M} pipelined vs plain stages", kernel, pipe, plain_out)

        # the main path: mk_bootstrap_pipelined -> NAND -> decrypt
        torch.cuda.synchronize()
        reset_launches(cuda_rotate)
        out, t_nand = sync_time(lambda: mk_pipeline.mk_bootstrap_pipelined(
            ck, shards, gates3gen.MU, t, mesh, M))
        counts = {"blind_rotate": cuda_rotate.blind_rotate_cuda.launches,
                  "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda.launches}
        if counts[kernel] != parties * M or counts[other]:
            raise AssertionError(f"{name} pipelined: launches {counts}, want {parties * M} of "
                                 f"{kernel} and none of {other}")
        res["launches"][kernel] += counts[kernel]
        wrong = int(mk.mk_decrypt(keys, out).ne(~(x & y)).sum())
        if wrong:
            raise AssertionError(f"{name} pipelined NAND: {wrong} wrong decryptions")
        form = {"bk_fb": full_key} if expanded else {"bk_fb_sel": full_key}
        ref = gates3gen.mk_gate_nand(dataclasses.replace(ck, **form), cx, cy)
        if not (torch.equal(out.a, ref.a) and torch.equal(out.b, ref.b)):
            raise AssertionError(f"{name} pipelined NAND != single-device mk_gate_nand")
        pipe_all = sorted(event_ms(pipelined, 1) for _ in range(PIPE_REPS))
        pipe_ms, single_ms = statistics.median(pipe_all), event_ms(single, 2)
        log(f"{'P3' if expanded else 'P2'} {name}", f"{PIPE_FORM[name]} key, B={B}, M={M}, "
            f"{parties} stages on {sorted({str(d) for d in mesh.party_devices()})}: pipelined == "
            f"single call == plain stages; NAND decrypts (0 wrong of {B}) == mk_gate_nand; "
            f"{kernel} launched {counts[kernel]}x, {other} 0x; pipelined rotate {pipe_ms:.3f} ms "
            f"(min {pipe_all[0]:.3f}, max {pipe_all[-1]:.3f} of {PIPE_REPS}) vs single call {single_ms:.3f} ms (ratio {pipe_ms / single_ms:.3f}), plain stages "
            f"{plain_s * 1e3:.1f} ms; pipelined NAND {t_nand:.3f} s = {B / t_nand:.1f} gates/s; "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        res["pipe_ms"][name] = pipe_ms
        p5_in = {"samples": ck.bk_samples.cpu(), "ks_mat": ck.ks_mat.cpu(),
                 "keys": torch.stack([k.key for k in keys]).cpu(), "x": x.cpu(), "y": y.cpu(),
                 "t_a": t.a.cpu(), "t_b": t.b.cpu(), "bara": bara.cpu(), "barb": barb.cpu(),
                 "pipe": pipe.cpu(), "out_a": out.a.cpu(), "out_b": out.b.cpu()}

        if parties == 8:  # P4: the party-sharded keyswitch of the pipelined extract
            u = rlwe_extract_sample(RLweSample(pipe))
            tables = sharded.mk_ks_tables_sharded(ck, mesh)
            got = sharded.mk_keyswitch_sharded(ck, tables, u, mesh)
            want = boot3gen.mk_keyswitch(ck, LweSample(u.a, u.b))
            if not (torch.equal(got.a[..., :parties, :], want.a) and torch.equal(got.b, want.b)):
                raise AssertionError("mk_keyswitch_sharded != mk_keyswitch at 8 parties")
            log("P4 keyswitch", f"{name}: mk_keyswitch_sharded over {parties} slots == "
                f"mk_keyswitch word for word (B={B})")
            p5_in.update(u_a=u.a.cpu(), u_b=u.b.cpu(), ks_a=want.a.cpu(), ks_b=want.b.cpu())
        np.savez(os.path.join(p5_dir, f"{name}.npz"), **p5_in)
        del shards, full_key, pipe, plain_out, out, ref, ck, sks, cx, cy, t, bara, barb
        torch.cuda.empty_cache()
    return res


def save_load_mk_key(ck, gate, want, name: str, B: int) -> None:
    """S1 for a 3gen cloud key: save it, load it back onto the card in the
    file's forms, and hold ``gate`` on the loaded key against ``want``, its
    words on the saved key."""
    import os
    import tempfile

    from torus_fhe_tpu_torch.utils import serialize

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mk_cloud.key")
        _, t_save = sync_time(lambda: serialize.save_mk_cloud_key(path, ck))
        size = os.path.getsize(path)
        ck2, t_load = sync_time(lambda: serialize.load_mk_cloud_key(path))
    if ck2.ks_mat.device != ck.ks_mat.device or ck2.parties != ck.parties or \
            ck2.params != ck.params:
        raise AssertionError(f"S1 {name}: the loaded key is not the saved one on the card")
    for form in ("bk_fb", "bk_fb_sel"):
        a, b = getattr(ck, form), getattr(ck2, form)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"S1 {name}: {form} of the loaded key differs")
    got = gate(ck2)
    if not (torch.equal(got.a, want.a) and torch.equal(got.b, want.b)):
        raise AssertionError(f"S1 {name}: the gate on the loaded key != on the saved key")
    log("S1 key files", f"{name} cloud key: {size / 1e6:.1f} MB on disk, saved in {t_save:.2f} s, "
        f"loaded onto the card in {t_load:.2f} s; mk_gate_and on the loaded key == on the saved "
        f"key word for word (B={B})")


def wide_route(dev, rng) -> dict:
    """The route of the 64-bit torus and of digits wider than a byte: torch
    ops on the card, no kernel (the JAX package runs it as an XLA scan
    outside Pallas). W1, W2 and W3 of the module docstring. Returns the
    ``routes`` record: per set, the launches of either kernel (0) and the
    int8 products of its main path."""
    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.boot import api, bootstrap, gates
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.core.torus import decode_message
    from torus_fhe_tpu_torch.lwe import LweSample
    from torus_fhe_tpu_torch.mk import boot3gen, gates3gen, keys3gen
    from torus_fhe_tpu_torch.ops import cuda_rotate, fblock, poly
    from torus_fhe_tpu_torch.rlwe import RLweSample, rlwe_extract_sample

    routes = {}

    def counts():
        return {"blind_rotate": cuda_rotate.blind_rotate_cuda.launches,
                "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda.launches,
                "int8_matmul": poly.int8_matmul.calls}

    def reset():
        reset_launches(cuda_rotate)
        poly.int8_matmul.calls = 0

    # W1. the scan on CUDA tensors == the scan on CPU tensors, small geometries
    worst = 0
    for tag, N, l, lb, bits in WIDE_SMALL:
        geom = fblock.fblock_geometry(WIDE_STEPS, N, 1, l, bits, 0)
        tg = P.TGswParams(l, lb, bits)
        args = (geom, tg.decomp_length, tg.log2_base, tg.offset)
        if cuda_rotate.takes_kernel_route(geom, lb):
            raise AssertionError(f"W1 {tag}: not on the wide route")
        samples = rand_torus(rng, (WIDE_STEPS, l, 2, 2, N), bits)
        sel = torch.from_numpy(fblock.build_sel(samples, geom))
        fb = fblock.build_fblocks(samples, geom, "cpu")
        sel_d, fb_d = sel.to(dev), fblock.build_fblocks(samples, geom, dev)
        if not torch.equal(fb_d.cpu(), fb):
            raise AssertionError(f"W1 {tag}: the key expanded on the card != on the CPU")
        mu = 1 << (bits - 3)
        for B in WIDE_RAGGED:
            acc = torch.from_numpy(rand_torus(rng, (B, 2, N), bits))
            bara = torch.from_numpy(rng.integers(0, 2 * N, (B, WIDE_STEPS)).astype(np.int32))
            barb = torch.from_numpy(rng.integers(-N, N, B).astype(np.int32))
            for mode, a, sv in (("acc", acc, None), ("stepvec", None, (mu, barb))):
                a_d = None if a is None else a.to(dev)
                sv_d = None if sv is None else (mu, barb.to(dev))
                want = cuda_rotate.rotate_streamed(a, sel, bara, *args, stepvec=sv)
                for what, got in (
                        ("streamed", cuda_rotate.rotate_streamed(a_d, sel_d, bara.to(dev), *args,
                                                                 stepvec=sv_d)),
                        ("expanded", cuda_rotate.rotate(a_d, fb_d, bara.to(dev), *args,
                                                        stepvec=sv_d))):
                    err = max_diff(got.cpu(), want)
                    worst = max(worst, err)
                    if got.device.type != dev.type or err:
                        raise AssertionError(f"W1 {tag} B={B} {mode} {what}: card != CPU, max "
                                             f"|diff| {err} on {got.device}")
        log("W1 wide==plain", f"{tag}: {WIDE_STEPS} steps, B in {WIDE_RAGGED}, both modes, compact "
            f"and expanded key: the scan on the card == on the CPU, max |diff| {worst}")

    # W2. mk_16party_3gen at full width and depth
    name, parties, B = WIDE_SET
    params = P.PARAMETER_REGISTRY[name]()
    forms = keys3gen.default_forms(params, parties)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(SEED + parties)
    t0 = time.perf_counter()
    sks = [mk.mk_party_keygen(gen, params, device=dev) for _ in range(parties)]
    ck = mk.mk_cloud_keygen(gen, sks, params, device=dev, forms=forms)
    torch.cuda.synchronize()
    t_keygen = time.perf_counter() - t0
    if ck.bk_fb is not None or forms != ("fbstream",):
        raise AssertionError(f"{name}: forms {forms}")
    keys = [sk.lwe for sk in sks]
    geom = keys3gen.mk_fb64_geometry(params, parties)
    tg = P.TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 64)
    args = (geom, tg.decomp_length, tg.log2_base, tg.offset)
    log(f"W2 {name}", f"{parties} party keygens + cloud keygen {t_keygen:.2f} s; compact key "
        f"{tuple(ck.bk_fb_sel.shape)} = {ck.bk_fb_sel.numel() / 1e9:.3f} GB, {len(geom.cols)} limb "
        f"columns, {geom.bits}-bit; keyswitch table {tuple(ck.ks_mat.shape)} = "
        f"{ck.ks_mat.numel() / 1e9:.3f} GB")
    msgs = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    ct, cy = mk.mk_encrypt(gen, keys, msgs, params), mk.mk_encrypt(gen, keys, ys, params)
    ct_true = mk.mk_encrypt(gen, keys, torch.ones(B, dtype=torch.bool, device=dev), params)
    torch.cuda.synchronize()
    reset()
    out, t_and = sync_time(lambda: gates3gen.mk_gate_and(ck, ct, ct_true))
    nand, t_nand = sync_time(lambda: gates3gen.mk_gate_nand(ck, out, cy))
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    if got["blind_rotate"] or got["blind_rotate_sel"]:
        raise AssertionError(f"{name}: the wide route launched a kernel: {got}")
    if got["int8_matmul"] != 2 * (geom.n + 1):
        raise AssertionError(f"{name}: {got['int8_matmul']} int8 products, want 2 gates x "
                             f"({geom.n} steps + 1 keyswitch)")
    routes[name] = {"route": "torch ops (fblock.blind_rotate_streamed, 64-bit)", **got,
                    "gates": 2, "batch": B}
    if out.a.shape != (B, parties, params.lwe_size) or out.a.dtype != torch.int32:
        raise AssertionError(f"{name}: gate output {out.a.dtype} {tuple(out.a.shape)}")
    wrong = int(mk.mk_decrypt(keys, out).ne(msgs).sum()) + \
        int(mk.mk_decrypt(keys, nand).ne(~(msgs & ys)).sum())
    if wrong:
        raise AssertionError(f"{name}: {wrong} wrong decryptions")
    log(f"W2 {name}", f"fbstream key, B={B}: AND and NAND decrypt correctly (0 wrong of {2 * B}); "
        f"blind_rotate 0x, blind_rotate_sel 0x, int8 products {got['int8_matmul']}; AND "
        f"{t_and:.3f} s = {B / t_and:.2f} gates/s, NAND {t_nand:.3f} s; peak memory "
        f"{peak / 1e9:.2f} GB")
    n2 = noise_3gen(name, sks, ck, gen, rng, dev)  # N2: the noise, through the report step
    if n2["blind_rotate"] or n2["blind_rotate_sel"]:
        raise AssertionError(f"{name} N2: the wide route launched a kernel: {n2}")

    # where a gate's time goes: the rotate (host against device), its parts, the keyswitch
    t = gates3gen.mk_gate_and_wb(ck, ct, ct_true)
    N = params.rlwe_polynomial_degree
    bara = decode_message(t.a, 2 * N).reshape(B, -1)
    sv = (gates3gen.MU, decode_message(t.b, 2 * N))
    acc, t_enq, t_rot = enqueue_and_total(
        lambda: cuda_rotate.rotate_streamed(None, ck.bk_fb_sel, bara, *args, stepvec=sv))
    steps = geom.n
    # at one gate the card has next to nothing to do: the chunk's wall time is the host's
    c_tot, c_enq, busy_ms, top, host_s = scan_split(ck.bk_fb_sel, bara, acc, args)
    (rows, K, cols, nl), bound_ms = scan_shapes(B, geom, tg.log2_base)
    gy = torch.Generator(device=dev).manual_seed(SEED)
    dexp = torch.randint(-128, 128, (rows, K), generator=gy, dtype=torch.int8, device=dev)
    fmat_t = torch.randint(-128, 128, (cols, K), generator=gy, dtype=torch.int8, device=dev)
    mm_ms = event_ms(lambda: poly.int8_matmul(dexp, fmat_t.t()), 20)
    mm_row_ms = event_ms(lambda: poly.int8_matmul(dexp, fmat_t.t().contiguous()), 5)
    exp_ms = event_ms(lambda: fblock.expand_kernel_chunk(ck.bk_fb_sel[:64], geom), 3)
    u = rlwe_extract_sample(RLweSample(acc))
    ks_ms = event_ms(lambda: boot3gen.mk_keyswitch(ck, LweSample(u.a, u.b)), 3)
    busy = "not measured" if busy_ms is None else f"{busy_ms / 64 * 1e3:.1f} us"
    log(f"W2 {name} rotate", f"B={B}, {steps} steps, {nl} limb blocks stacked: one int8 product ({rows} x {K}) @ ({K} x {cols}) a step; rotate "
        f"{t_rot * 1e3:.1f} ms = {t_rot / steps * 1e6:.1f} us a step, host enqueue "
        f"{t_enq * 1e3:.1f} ms = {t_enq / steps * 1e6:.1f} us a step; bound from shapes "
        f"{bound_ms:.1f} ms as multiplied ({bound_ms / 2:.1f} ms for the non-zero half)")
    log(f"W2 {name} parts", f"one 64-step chunk: {c_tot * 1e3:.2f} ms wall ({c_enq * 1e3:.2f} ms "
        f"host enqueue), the same chunk at B=1 {host_s * 1e3:.2f} ms = {host_s / 64 * 1e6:.1f} us "
        f"a step (the host's share: ops issued one by one), kernels on the card {busy} a step "
        f"(torch.profiler; top: "
        f"{'; '.join(top) if top else 'none'}); alone by CUDA events: the int8 product "
        f"{mm_ms * 1e3:.1f} us with the key side's reduction index contiguous (row-major, copy "
        f"included: {mm_row_ms * 1e3:.1f} us), the chunk's expansion {exp_ms:.3f} ms = {exp_ms / 64 * 1e3:.1f} us "
        f"a step; keyswitch ({B} x {ck.ks_mat.shape[0]}) @ {tuple(ck.ks_mat.shape)} "
        f"{ks_ms:.3f} ms")
    del sks, ck, ct, cy, ct_true, out, nand, t, bara, sv, acc, dexp, fmat_t, u
    torch.cuda.empty_cache()

    # W3. tfhe_80: single key, Bg = 2^10 on the 32-bit torus
    p80 = P.tfhe_parameters_80()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(SEED + 80)
    (sk, ck80), t_keygen = sync_time(lambda: api.make_key_pair(gen, p80, device=dev))
    B = TFHE80_BATCH
    x = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    cx, cy = api.encrypt(gen, sk, x), api.encrypt(gen, sk, y)
    torch.cuda.synchronize()
    reset()
    out, t_and = sync_time(lambda: gates.gate_and(ck80, cx, cy))
    got = counts()
    if got["blind_rotate"] or got["blind_rotate_sel"] or got["int8_matmul"] != p80.lwe_size + 1:
        raise AssertionError(f"tfhe_80: {got}, want no kernel launch and "
                             f"{p80.lwe_size + 1} int8 products")
    routes["tfhe_80"] = {"route": "torch ops (fblock.blind_rotate_fblock, 32-bit, Bg=2^10)",
                         **got, "gates": 1, "batch": B}
    if not torch.equal(api.decrypt(sk, out), x & y):
        raise AssertionError("tfhe_80 bootsAND decrypts wrong")
    nand = gates.gate_nand(ck80, out, cy)
    if not torch.equal(api.decrypt(sk, nand), ~((x & y) & y)):
        raise AssertionError("tfhe_80 NAND of a bootstrapped output decrypts wrong")
    gate_s = [sync_time(lambda: gates.gate_and(ck80, cx, cy))[1] for _ in range(3)]
    fb = ck80.bootstrap_key.fb
    g80 = bootstrap.bk_geometry(p80)
    nl80 = len(poly.digits_to_i8_rows(torch.zeros((1, 8), dtype=torch.int32), p80.bs_log2_base))
    macs80 = (p80.lwe_size * nl80 * B * g80.nb * g80.D * g80.R * g80.bs
              * len(g80.cols) * g80.bs)
    log("W3 tfhe_80", f"B={B}: bootsAND and a NAND of its output decrypt correctly; "
        f"blind_rotate 0x, blind_rotate_sel 0x, int8 products {got['int8_matmul']} a gate; keygen "
        f"{t_keygen:.2f} s, key {tuple(fb.shape)} = {fb.numel() / 1e9:.2f} GB; bootsAND "
        f"{t_and:.3f} s cold, {B / statistics.mean(gate_s):.1f} gates/s "
        f"({statistics.mean(gate_s) / p80.lwe_size * 1e6:.1f} us a step; bound from shapes "
        f"{2 * macs80 / cuda_rotate.INT8_OPS_PER_S * 1e3:.1f} ms a gate batch as multiplied, "
        f"{nl80} limb blocks); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del sk, ck80, cx, cy, out, nand, fb
    torch.cuda.empty_cache()
    return routes


def scan_route(name: str, sk, ck, x, y, gen, routes: dict) -> int:
    """V1: the single-key scan route (boot/bootstrap.py: the CMux chain of
    mux_rotate over the packed TGSW kernels, torch ops) against the
    kernel's route on one key. The conv form is rebuilt from the samples of
    ``ck`` (no keygen); bootsAND runs with set_rotate_backend("scan") and
    with "auto" (the Hopper kernel, K2, on the F-block key), each with the
    counts at 0 before it: equal words, 0 wrong decryptions, no kernel
    launch on the scan route and one on the kernel's. Adds a record to
    ``routes``; returns the kernel's launches."""
    from torus_fhe_tpu_torch.boot import api, bootstrap, gates
    from torus_fhe_tpu_torch.ops import cuda_rotate, poly

    params = ck.params
    B = x.shape[0]
    conv, t_rebuild = sync_time(lambda: bootstrap.rebuild_bk_forms(
        ck.bootstrap_key.samples, params, ("conv",), DEVICE).kernels)
    both = api.CloudKey(params, ck.bootstrap_key._replace(kernels=conv), ck.keyswitch_key)
    cx, cy = api.encrypt(gen, sk, x), api.encrypt(gen, sk, y)
    outs, times, counts = {}, {}, {}
    for route in ("scan", "auto"):
        bootstrap.set_rotate_backend(route)
        try:
            reset_launches(cuda_rotate)
            poly.int8_matmul.calls = 0
            outs[route], cold = sync_time(lambda: gates.gate_and(both, cx, cy))
            counts[route] = {"blind_rotate": cuda_rotate.blind_rotate_cuda.launches,
                             "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda.launches,
                             "int8_matmul": poly.int8_matmul.calls}
            times[route] = [cold, sync_time(lambda: gates.gate_and(both, cx, cy))[1]]
        finally:
            bootstrap.set_rotate_backend("auto")
    scan, auto = counts["scan"], counts["auto"]
    if scan["blind_rotate"] or scan["blind_rotate_sel"] or scan["int8_matmul"] < params.lwe_size:
        raise AssertionError(f"V1 {name}: the scan route's counts {scan}")
    if auto["blind_rotate"] != 1 or auto["blind_rotate_sel"]:
        raise AssertionError(f"V1 {name}: 'auto' launched {auto}, want blind_rotate once")
    err = max(max_diff(outs["scan"].a, outs["auto"].a), max_diff(outs["scan"].b, outs["auto"].b))
    wrong = {r: int(api.decrypt(sk, o).ne(x & y).sum()) for r, o in outs.items()}
    if err or any(wrong.values()):
        raise AssertionError(f"V1 {name}: scan != kernel words (max |diff| {err}) or wrong "
                             f"decryptions {wrong}")
    geom = bootstrap.bk_geometry(params)
    bound, by = cuda_rotate.rotate_bound_ms(B, geom, conv.numel())
    sizes = {"conv_bytes": conv.numel(), "fblock_bytes": ck.bootstrap_key.fb.numel()}
    log(f"V1 {name}", f"bootsAND B={B}: scan route == kernel route word for word, 0 wrong of "
        f"{B} on both; scan {times['scan'][1] * 1e3:.1f} ms ({scan['int8_matmul']} int8 "
        f"products, no kernel launch), kernel {times['auto'][1] * 1e3:.2f} ms "
        f"(blind_rotate {auto['blind_rotate']}x); conv key {conv.numel() / 1e6:.1f} MB from "
        f"shapes {tuple(conv.shape)} (rebuilt in {t_rebuild:.2f} s) against the F-block key's "
        f"{ck.bootstrap_key.fb.numel() / 1e9:.2f} GB; the rotate's bound {bound:.3f} ms ({by}) "
        f"[{SMI}]")
    routes[f"V1 {name}"] = {"route": "torch ops (scan: mux_rotate, Toeplitz int8 products)",
                            "batch": B, "scan_s": times["scan"], "kernel_s": times["auto"],
                            "scan_counts": scan, "kernel_counts": auto, "wrong": wrong["scan"],
                            "max_abs_err": err, "bound_ms": bound, "bound_by": by,
                            "rebuild_s": t_rebuild, **sizes}
    return auto["blind_rotate"]


def conv_route(tag: str, name: str, scheme, ck_fb, ck_conv, cx, cy, keys, want_bits,
               allowed: int) -> dict:
    """V2 (CCS) and V3 (KMS, fast_boot True and False): the NAND of the
    first V_BATCH pairs on the conv form (the packed kernels, the exact
    Toeplitz products) against the same NAND on the fb form of the same
    keygen, each with the counts at 0 before it: equal words, no kernel
    launch, at most ``allowed`` wrong decryptions. Returns the record."""
    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.mk import ccs
    from torus_fhe_tpu_torch.ops import cuda_rotate, poly

    B = V_BATCH
    xs, ys = (mk.MKLweSample(c.a[:B], c.b[:B]) for c in (cx, cy))
    short = "ccs" if scheme is ccs else "kms"
    sizes = {f: tuple(getattr(ck_conv, f).shape) for f in CONV_FIELDS[short]}
    rec = {"batch": B, "conv_bytes": sum(math.prod(v) for v in sizes.values()),
           "conv_shapes": sizes}
    for fast in ((None,) if scheme is ccs else (True, False)):
        args = () if fast is None else (fast,)
        reset_launches(cuda_rotate)
        poly.int8_matmul.calls = 0
        got, t_conv = sync_time(lambda: scheme.mk_gate_nand(ck_conv, xs, ys, *args))
        got_n = {"blind_rotate": cuda_rotate.blind_rotate_cuda.launches,
                 "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda.launches,
                 "int8_matmul": poly.int8_matmul.calls}
        if got_n["blind_rotate"] or got_n["blind_rotate_sel"]:
            raise AssertionError(f"{tag} {name}: the conv route launched a kernel: {got_n}")
        want, t_fb = sync_time(lambda: scheme.mk_gate_nand(ck_fb, xs, ys, *args))
        err = max(max_diff(got.a, want.a), max_diff(got.b, want.b))
        wrong = int(mk.mk_decrypt(keys, got).ne(want_bits[:B]).sum())
        mode = "" if fast is None else f" fast_boot={fast}"
        if err or wrong > allowed:
            raise AssertionError(f"{tag} {name}{mode}: conv != fb words (max |diff| {err}) or "
                                 f"{wrong} wrong (at most {allowed})")
        log(f"{tag} {name}{mode}", f"NAND B={B}: conv route == fb route word for word, {wrong} "
            f"wrong; conv {t_conv:.3f} s ({got_n['int8_matmul']} int8 products, no kernel "
            f"launch), fb {t_fb:.3f} s; conv form {rec['conv_bytes'] / 1e6:.1f} MB from shapes "
            f"{sizes} [{SMI}]")
        rec["fast_boot" if fast is None else f"fast_boot_{fast}"] = {
            "conv_s": t_conv, "fb_s": t_fb, "wrong": wrong, "max_abs_err": err, **got_n}
    return rec


def native_phase(dev) -> dict:
    """V4: the host native runtime (ops/native.py): built from
    csrc/host_native.cpp with g++ here (a failed build fails the phase);
    share_secret_streaming of a thfhe_1024 ring key, 3 of 5, through it ==
    the numpy path on the same draws, and the shares of two subsets decrypt
    a ciphertext on the card; its product == the numpy one at N = 1024.
    Returns the ``routes`` record."""
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.ops import hostmath, native
    from torus_fhe_tpu_torch.rlwe import rlwe_encrypt, rlwe_keygen
    from torus_fhe_tpu_torch.threshold import decrypt as tdec
    from torus_fhe_tpu_torch.threshold import shares as tsh

    name, t, p = V4_SHARING
    so, t_build = sync_time(native.build)
    if not native.available():
        raise AssertionError(f"V4: the host native library did not load ({so})")
    rp = P.PARAMETER_REGISTRY[name]().rlwe
    g = torch.Generator().manual_seed(SEED + 40)
    rk = rlwe_keygen(g, rp, device=dev)
    calls = []
    stream, avail = native.bl_shares_stream, native.available
    native.bl_shares_stream = lambda *a: calls.append(1) or stream(*a)
    try:
        got, t_native = sync_time(lambda: tsh.share_secret_streaming(
            rk.key, t, p, torch.Generator().manual_seed(SEED + 41)))
        native.available = lambda: False  # the numpy path, on the same draws
        want, t_numpy = sync_time(lambda: tsh.share_secret_streaming(
            rk.key, t, p, torch.Generator().manual_seed(SEED + 41)))
    finally:
        native.bl_shares_stream, native.available = stream, avail
    if calls != [1] or sorted(got.shares) != sorted(want.shares) or any(
            not np.array_equal(got.shares[k], v) for k, v in want.shares.items()):
        raise AssertionError(f"V4: native shares != numpy shares (library calls {len(calls)})")
    ct = rlwe_encrypt(g, tdec.encode_bits(0xC0DE, rp.polynomial_degree, n_bits=16, device=dev),
                      1e-3, rk, rp, device=dev)
    for subset in ([1, 2, 4], [3, 4, 5]):
        plain = tdec.threshold_decrypt(ct, got, subset, 0.0, g)
        if tdec.decode_bits(plain, n_bits=16) != 0xC0DE:
            raise AssertionError(f"V4: the shares of {subset} do not decrypt")
    rng = np.random.default_rng(SEED + 42)
    a = rng.integers(-1, 2, (8, rp.polynomial_degree), dtype=np.int32)
    b = rng.integers(-2**31, 2**31, (8, rp.polynomial_degree), dtype=np.int64).astype(np.int32)
    prod, t_prod = sync_time(lambda: native.negacyclic_polymul(a, b, 32))
    if not np.array_equal(prod, hostmath.negacyclic_polymul_host(a, b, 32)):
        raise AssertionError("V4: the native product != the numpy product")
    omp = "with OpenMP" if native.openmp() else "without OpenMP (its -fopenmp build failed)"
    log("V4 native", f"{so} {omp}, built at its first use in this run (found or built here in "
        f"{t_build:.2f} s); share_secret_streaming {name} {t} of {p}: "
        f"{len(got.shares)} shares through the library in {t_native * 1e3:.1f} ms == the numpy "
        f"path's ({t_numpy * 1e3:.1f} ms); subsets [1, 2, 4] and [3, 4, 5] decrypt 0xC0DE on "
        f"the card; 8 products at N={rp.polynomial_degree} == numpy ({t_prod * 1e3:.1f} ms) "
        f"[{SMI}]")
    return {"V4 native": {"route": "host C++ (g++ -O3)", "openmp": native.openmp(),
                          "build_s": t_build,
                          "shares": len(got.shares), "native_s": t_native, "numpy_s": t_numpy,
                          "product_s": t_prod}}


def scheme_phases(dev, rng) -> dict:
    """E1-E3: the 1st-gen (CCS) and 2nd-gen (KMS) multikey schemes, torch ops
    on the card (neither kernel launches; the JAX package runs both outside
    Pallas). E1 mk_2party_ccs and E2 mk_2party_kms at full registry width:
    party keygens and the cloud key on the card, a NAND batch over all four
    input pairs decrypt-checked with max |phase - ideal| under PHASE_BOUND,
    its wall time, the host/device split of a CMux step, the int8 products
    and the bound from shapes (KMS: its rotates and its relinearisation
    apart, and a fast_boot=False batch). E3: the card's words against the
    CPU's on the same keys at the test sets, and a save -> load round trip
    of each full-width key on the card. Returns the ``routes`` records."""
    import dataclasses
    import os
    import tempfile

    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.mk import ccs, kms
    from torus_fhe_tpu_torch.tools.perf_comp import CCS_NOISE_BAND, PHASE_BOUND, key_bytes
    from torus_fhe_tpu_torch.tools.scheme_noise import allowed_wrong, ccs_noise_std, phase_error
    from torus_fhe_tpu_torch.utils import serialize

    routes, kept = {}, {}
    for name, B in SCHEME_SETS:
        scheme = ccs if name.endswith("_ccs") else kms
        tag = "E1" if scheme is ccs else "E2"
        params = P.PARAMETER_REGISTRY[name]()
        parties, n, N = params.max_parties, params.lwe_size, params.rlwe_polynomial_degree
        keygen = ccs.ccs_party_keygen if scheme is ccs else kms.kms_party_keygen
        cloud = ccs.ccs_cloud_keygen if scheme is ccs else kms.kms_cloud_keygen
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator().manual_seed(SEED + 200 + parties)
        t0 = time.perf_counter()
        sks = [keygen(gen, params, device=dev) for _ in range(parties)]
        short = "ccs" if scheme is ccs else "kms"
        both = cloud(gen, sks, params, device=dev, forms=("fb", "conv"))  # V2, V3: one keygen
        ck = dataclasses.replace(both, **{f: None for f in CONV_FIELDS[short]})
        ck_conv = dataclasses.replace(both, **{f: None for f in FB_FIELDS[short]})
        del both
        torch.cuda.synchronize()
        t_keygen = time.perf_counter() - t0
        keys = [sk.lwe for sk in sks]
        pairs = torch.from_numpy(rng.permutation(np.arange(B) % 4)).to(dev)
        x, y = pairs >= 2, pairs % 2 == 1
        cx, cy = mk.mk_encrypt(gen, keys, x, params), mk.mk_encrypt(gen, keys, y, params)
        out, t_cold, got = scheme_nand(f"{tag} {name}", scheme, ck, cx, cy)
        wrong = int(mk.mk_decrypt(keys, out).ne(~(x & y)).sum())
        peak = torch.cuda.max_memory_allocated()
        # N4: the noise, through the harness's report step on this key
        rep = noise_scheme(f"N4 {name}", "ccs" if scheme is ccs else "kms", sks, ck, gen, rng, dev)
        err_max, err_std = rep.boot_noise_max, rep.boot_noise_std
        over = int((np.abs(rep.boot_noises) >= PHASE_BOUND).sum())
        if scheme is ccs:
            # the scheme's own noise puts 1/16 at ~2 std: the std is held to
            # its prediction on this key, the wrong counts to what that std allows
            pred = ccs_noise_std(params, ck, sks)
            allowed = allowed_wrong(B, pred * CCS_NOISE_BAND[1])
            ok = (max(wrong, rep.wrong_decryptions) <= allowed
                  and CCS_NOISE_BAND[0] <= err_std / pred <= CCS_NOISE_BAND[1])
            gate = (f"boot-noise std {err_std:.5f} = {err_std / pred:.3f}x the predicted "
                    f"{pred:.5f} (band {CCS_NOISE_BAND}), {wrong} and {rep.wrong_decryptions} "
                    f"wrong (at most {allowed})")
        else:
            ok = wrong == 0 and rep.wrong_decryptions == 0 and err_max < PHASE_BOUND
            gate = f"{wrong} and {rep.wrong_decryptions} wrong, max |phase - ideal| under {PHASE_BOUND}"
        log(f"{tag} {name}", f"{parties} party keygens + cloud keygen {t_keygen:.2f} s; key on the "
            f"card {key_bytes(ck) / 1e6:.1f} MB; NAND B={B} (all four input pairs): {wrong} wrong "
            f"of {B}; N4 ({rep.trials} NAND(m, 1)): max |phase - ideal| {err_max:.5f}, {over} at "
            f"or over {PHASE_BOUND}, boot-noise std {err_std:.5f}; {t_cold:.3f} s; blind_rotate "
            f"0x, blind_rotate_sel 0x, int8 products {got['int8_matmul']}; peak memory "
            f"{peak / 1e9:.2f} GB; held to: {gate}: {'met' if ok else 'NOT MET'}")
        if not ok:
            raise AssertionError(f"{tag} {name}: {gate} not met")
        t_warm = sync_time(lambda: scheme.mk_gate_nand(ck, cx, cy))[1]
        log(f"{tag} {name}", f"NAND B={B} warm {t_warm:.3f} s = {B / t_warm:.1f} gates/s")
        temp = mk.mk_lwe_noiseless_trivial(ccs.MU, params.lwe, parties, (B,), device=dev) - cx - cy
        rec = {"route": "torch ops (F-block products, 32-bit)" if scheme is ccs else
               "torch ops (64-bit F-block scan, Toeplitz products)", **got, "gates": 1, "batch": B,
               "keygen_s": t_keygen, "key_bytes": key_bytes(ck), "nand_s": [t_cold, t_warm],
               "wrong": wrong, "report_wrong": rep.wrong_decryptions, "phase_err_max": err_max,
               "over_bound": over, "boot_noise_std": err_std,
               "rounded_phase_gt_quarter_lt_zero": [rep.wrong_phase_gt_quarter,
                                                    rep.wrong_phase_lt_zero]}
        if scheme is ccs:
            rec.update(ccs_split(ck, temp, B, tag, name))
        else:
            rec.update(kms_split(ck, temp, B, tag, name))
            xs, ys = (mk.MKLweSample(c.a[:KMS_SLOW_BATCH], c.b[:KMS_SLOW_BATCH]) for c in (cx, cy))
            slow, t_slow = sync_time(lambda: kms.mk_gate_nand(ck, xs, ys, fast_boot=False))
            want = ~(x[:KMS_SLOW_BATCH] & y[:KMS_SLOW_BATCH])
            wrong_s, err_s, std_s, _ = phase_error(slow, keys, want, PHASE_BOUND)
            if wrong_s or not err_s < PHASE_BOUND:
                raise AssertionError(f"{tag} {name} fast_boot=False: {wrong_s} wrong, max |phase "
                                     f"- ideal| {err_s:.5f}")
            a8 = torch.ones((2, 32, 32), dtype=torch.int8, device=dev)
            try:  # why the runtime-kernel product takes one element a product
                torch.bmm(a8, a8)
                bmm = "runs"
            except (NotImplementedError, RuntimeError) as err:
                bmm = f"refused: {str(err).splitlines()[0][:80]}"
            log(f"{tag} {name}", f"torch.bmm of int8 CUDA tensors {bmm}")
            rec["slow_boot"] = {"batch": KMS_SLOW_BATCH, "nand_s": t_slow, "wrong": wrong_s,
                                "phase_err_max": err_s, "boot_noise_std": std_s}
            log(f"{tag} {name} fast_boot=False", f"NAND B={KMS_SLOW_BATCH}: 0 wrong, max |phase - "
                f"ideal| {err_s:.5f}, std {std_s:.5f}; {t_slow:.3f} s (both parties through "
                "the TLev rotate and the relinearisation)")
        # V2 / V3: the conv form of the same keygen against the fb form
        allowed = allowed_wrong(V_BATCH, ccs_noise_std(params, ck, sks) * CCS_NOISE_BAND[1]) \
            if scheme is ccs else 0
        rec["conv"] = conv_route("V2" if scheme is ccs else "V3", name, scheme, ck, ck_conv,
                                 cx, cy, keys, ~(x & y), allowed)
        routes[name] = rec
        kept[name] = (scheme, ck, cx, cy, out)
        del sks, temp, ck_conv
        torch.cuda.empty_cache()

    # E3. the same keys on the card and on the CPU at the test sets: equal words
    for scheme, make in ((ccs, P.test_parameters_ccs), (kms, P.test_parameters_kms)):
        keygen = ccs.ccs_party_keygen if scheme is ccs else kms.kms_party_keygen
        cloud = ccs.ccs_cloud_keygen if scheme is ccs else kms.kms_cloud_keygen
        short = "ccs" if scheme is ccs else "kms"
        for parties, gadgets in E3_SETS:
            params = make(parties=parties)
            if gadgets:  # the registry set's gadgets on the test set's n and N
                reg = P.PARAMETER_REGISTRY[f"mk_{gadgets}_{short}"]()
                params = dataclasses.replace(params, **{f: getattr(reg, f)
                                                        for f in GADGET_FIELDS[short]})
            outs = {}
            for where in ("cpu", dev):
                gen = torch.Generator().manual_seed(SEED + 300 + parties)
                sks = [keygen(gen, params, device=where) for _ in range(parties)]
                ck = cloud(gen, sks, params, device=where)
                keys = [sk.lwe for sk in sks]
                bits = torch.from_numpy(np.arange(8) % 4).to(where)
                cx, cy = (mk.mk_encrypt(gen, keys, v, params) for v in (bits >= 2, bits % 2 == 1))
                outs[str(where)] = ([ccs.mk_gate_nand(ck, cx, cy)] if scheme is ccs else
                                    [kms.mk_gate_nand(ck, cx, cy, fb) for fb in (True, False)])
                for out in outs[str(where)]:
                    wrong, err_max, _, _ = phase_error(out, keys, ~((bits >= 2) & (bits % 2 == 1)),
                                                       PHASE_BOUND)
                    if wrong or not err_max < PHASE_BOUND:  # the JAX test's bound at its set
                        raise AssertionError(f"E3 {short} {parties} parties {gadgets} on {where}: "
                                             f"{wrong} wrong, max |phase - ideal| {err_max:.5f}")
            err = max(max_diff(c.a.cpu(), g.a) + max_diff(c.b.cpu(), g.b)
                      for c, g in zip(outs[str(dev)], outs["cpu"]))
            if err:
                raise AssertionError(f"E3 {short} {parties} parties {gadgets}: card != CPU, max "
                                     f"|diff| {err}")
            log("E3 card==CPU", f"{short} test set, {parties} parties"
                + (f", mk_{gadgets}_{short}'s gadgets" if gadgets else "")
                + f", same keys: NAND words on the card == on the CPU, max |diff| {err}"
                + (" (fast_boot True and False)" if scheme is kms else ""))

    with tempfile.TemporaryDirectory() as tmp:
        for name, (scheme, ck, cx, cy, out) in kept.items():
            short = "ccs" if scheme is ccs else "kms"
            path = os.path.join(tmp, f"{name}.key")
            _, t_save = sync_time(lambda: getattr(serialize, f"save_{short}_cloud_key")(path, ck))
            size = os.path.getsize(path)
            ck2, t_load = sync_time(lambda: getattr(serialize, f"load_{short}_cloud_key")(path))
            for f in dataclasses.fields(ck):
                v = getattr(ck, f.name)
                if isinstance(v, torch.Tensor) and (getattr(ck2, f.name).device.type != dev.type
                                                    or not torch.equal(getattr(ck2, f.name), v)):
                    raise AssertionError(f"E3 {name}: the loaded {f.name} differs or is off the card")
            again = scheme.mk_gate_nand(ck2, cx, cy)
            if not (torch.equal(again.a, out.a) and torch.equal(again.b, out.b)):
                raise AssertionError(f"E3 {name}: NAND on the loaded key != on the saved key")
            routes[name]["file"] = {"bytes": size, "save_s": t_save, "load_s": t_load}
            log("E3 key file", f"{name}: {size / 1e6:.1f} MB on disk, saved in {t_save:.2f} s, "
                f"loaded onto the card in {t_load:.2f} s; NAND on the loaded key == on the saved "
                f"key word for word (B={out.b.shape[0]})")
            del ck2, again
    del kept
    torch.cuda.empty_cache()
    return routes


def scheme_nand(tag: str, scheme, ck, cx, cy):
    """One CCS or KMS NAND batch with the counts at 0 just before it:
    (output, wall seconds, launches of each kernel and int8 products). Fails
    if a kernel launched, if a CCS gate's int8 products are not P+3 a CMux
    step and one keyswitch a party, or if the output is not (B, P, n)
    int32."""
    from torus_fhe_tpu_torch.mk import ccs
    from torus_fhe_tpu_torch.ops import cuda_rotate, poly

    P, n, B = ck.parties, ck.params.lwe_size, cx.b.shape[0]
    torch.cuda.synchronize()
    reset_launches(cuda_rotate)
    poly.int8_matmul.calls = 0
    out, wall = sync_time(lambda: scheme.mk_gate_nand(ck, cx, cy))
    got = {"blind_rotate": cuda_rotate.blind_rotate_cuda.launches,
           "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda.launches,
           "int8_matmul": poly.int8_matmul.calls}
    if got["blind_rotate"] or got["blind_rotate_sel"]:
        raise AssertionError(f"{tag}: a kernel launched: {got}")
    if scheme is ccs and got["int8_matmul"] != P * n * (P + 3) + P:
        raise AssertionError(f"{tag}: {got['int8_matmul']} int8 products, want {P * n} steps x "
                             f"{P + 3} + {P} keyswitches")
    if out.a.shape != (B, P, n) or out.a.dtype != torch.int32:
        raise AssertionError(f"{tag}: gate output {out.a.dtype} {tuple(out.a.shape)}")
    return out, wall, got


def noise_scheme(tag: str, scheme: str, sks, ck, gen, rng, dev):
    """N4: the CCS or KMS report step on a key held here, N4_TRIALS
    messages; no kernel may launch. Prints the report's JSON on a line of
    its own; the caller holds it to its scheme's bounds."""
    rep, counts, wall = mk_report(sks, ck, scheme, N4_TRIALS, gen, rng, dev)
    if any(counts.values()):
        raise AssertionError(f"{tag}: a kernel launched: {counts}")
    log(tag, f"{rep.trials} trials in {wall:.2f} s: {rep.wrong_decryptions} wrong; boot-noise std "
        f"{rep.boot_noise_std:.5f}, max {rep.boot_noise_max:.5f}; rounded phase > 1/4: "
        f"{rep.wrong_phase_gt_quarter}, < 0: {rep.wrong_phase_lt_zero}; classes of the wrong: "
        f"{rep.wrong_classes}")
    print(json.dumps({"noise": tag, **json.loads(rep.to_json())}), flush=True)
    return rep


def ccs_split(ck, temp, B: int, tag: str, name: str, full: bool = True) -> dict:
    """Where a CCS gate's time goes: the rotate (``full``: a second whole
    rotate, timed), host against device a CMux step on a 64-step chunk, and
    the bound from shapes."""
    import dataclasses

    from torus_fhe_tpu_torch.mk import ccs
    from torus_fhe_tpu_torch.tools import perf_comp

    params = ck.params
    P, N = ck.parties, params.rlwe_polynomial_degree
    acc, bara = ccs.rotate_input(ccs.MU, temp, N, P, torch.int32)
    bara = bara.flatten(1)
    steps = bara.shape[1]
    if full:
        _, t_enq, t_rot = enqueue_and_total(lambda: ccs.ccs_blind_rotate_fb(acc, ck, bara))
    part = dataclasses.replace(ck, d_sel=ck.d_sel[:64], f0_sel=ck.f0_sel[:64],
                               f1_sel=ck.f1_sel[:64])
    busy_ms, top = device_busy(lambda: ccs.ccs_blind_rotate_fb(acc, part, bara[:, :64]))
    one = lambda: ccs.ccs_blind_rotate_fb(acc[:1], part, bara[:1, :64])
    one()
    host_s = min(sync_time(one)[1] for _ in range(3))
    nl = perf_comp.digit_limbs(params.bs_log2_base)
    bound, by = perf_comp.ccs_bound(ck, B)
    busy = None if busy_ms is None else busy_ms / 64
    rec = {"host_step_ms_b1": host_s / 64 * 1e3, "device_step_ms": busy, "bound_ms": bound,
           "bound_by": by}
    rotate = ""
    if full:
        rotate = (f": rotate {t_rot * 1e3:.1f} ms = {t_rot / steps * 1e3:.3f} ms a step, host "
                  f"enqueue {t_enq / steps * 1e3:.3f} ms a step")
        rec.update(rotate_s=t_rot, step_ms=t_rot / steps * 1e3,
                   host_enqueue_step_ms=t_enq / steps * 1e3)
    log(f"{tag} {name} rotate", f"B={B}, {steps} CMux steps, {P + 3} int8 products a step "
        f"(u, {P + 1} x v, w0|w1), {nl} digit limb blocks{rotate}; a 64-step chunk at B=1 "
        f"{host_s / 64 * 1e3:.3f} ms a step (the host's share), kernels on the card "
        f"{'not measured' if busy is None else f'{busy:.3f} ms'} a step at B={B} "
        f"(torch.profiler; top: {'; '.join(top) if top else 'none'}); bound from shapes "
        f"{bound:.1f} ms a gate batch ({by})")
    return rec


def kms_split(ck, temp, B: int, tag: str, name: str, full: bool = True) -> dict:
    """Where a KMS gate's time goes: (``full``: the gate again, part by
    part) party 0's single-key rotate and its uni-product entry, each other
    party's TLev rotate and its relinearisation (TLev product +
    uni-product); host against device a TLev CMux step on a 64-step chunk,
    and the bound from shapes."""
    from torus_fhe_tpu_torch.mk import ccs, kms
    from torus_fhe_tpu_torch.ops import fblock
    from torus_fhe_tpu_torch.tools import perf_comp

    params = ck.params
    P, N, n = ck.parties, params.rlwe_polynomial_degree, params.lwe_size
    gp, geom = params.tgsw, kms.kms_fb_geometry(params, n)
    acc, bara = ccs.rotate_input(kms.MU64, temp, N, P, torch.int64)
    rot = lambda a, sel, b: fblock.blind_rotate_streamed(a, sel, b, geom, gp.decomp_length,
                                                         gp.log2_base, gp.offset)
    rec = {}
    if full:
        sacc = torch.stack([torch.zeros_like(acc[:, P]), acc[:, P]], dim=1)
        sacc, t_single = sync_time(lambda: rot(sacc, ck.gsw_sel[:n], bara[:, 0]))
        e, f = torch.zeros_like(acc), torch.zeros_like(acc)
        e[:, P], f[:, P] = sacc[:, 0], sacc[:, 1]
        acc1, t_uni0 = sync_time(lambda: f - kms.uni_product_new(e, ck, 0))
        times = {"single_rotate": t_single, "uni_entry": t_uni0}
        for p in range(1, P):
            lev, times[f"lev_rotate_{p}"] = sync_time(
                lambda: kms._lev_blind_rotate(ck, p, bara[:, p], 64))
            ef, times[f"tlev_product_{p}"] = sync_time(
                lambda: kms.tlev_extern_mul(acc1, lev, params))
            uni, times[f"uni_product_{p}"] = sync_time(
                lambda: kms.uni_product_new(ef[..., 0, :], ck, p))
            acc1 = ef[..., 1, :] - uni
        rotates = sum(v for k, v in times.items() if "rotate" in k)
        relin = sum(v for k, v in times.items() if "rotate" not in k)
        rec = {"parts_s": times, "rotates_s": rotates, "relin_s": relin,
               "lev_step_ms": times["lev_rotate_1"] / n * 1e3,
               "single_step_ms": t_single / n * 1e3}
        log(f"{tag} {name} parts", ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items())
            + f"; rotates {rotates * 1e3:.1f} ms, relinearisation {relin * 1e3:.1f} ms")
    llev = params.lev_decomp_length
    lev_rows = B * llev
    chunk_acc = torch.zeros((lev_rows, 2, N), dtype=torch.int64, device=acc.device)
    chunk_bara = bara[:, 1:2].expand(B, llev, n).reshape(lev_rows, n)[:, :64]
    busy_ms, top = device_busy(lambda: rot(chunk_acc, ck.gsw_sel[n:n + 64], chunk_bara))
    one = lambda: rot(chunk_acc[:1], ck.gsw_sel[n:n + 64], chunk_bara[:1])
    one()
    host_s = min(sync_time(one)[1] for _ in range(3))
    nl, cols = perf_comp.digit_limbs(gp.log2_base), len(geom.cols)
    bound, by = perf_comp.kms_bound(ck, B)
    busy = None if busy_ms is None else busy_ms / 64
    steps = (f"{rec['lev_step_ms']:.3f} ms a step; single-key rotate (B={B}) "
             f"{rec['single_step_ms']:.3f} ms a step; ") if full else ""
    log(f"{tag} {name} rotate", f"TLev rotate of B*l_lev = {lev_rows} rows, {n} steps, one int8 "
        f"product a step ({nl} digit limb blocks, {cols} limb columns, 64-bit): {steps}a "
        f"64-step chunk at one row {host_s / 64 * 1e3:.3f} ms a step (the host's share), kernels "
        f"on the card {'not measured' if busy is None else f'{busy:.3f} ms'} a step at "
        f"{lev_rows} rows (torch.profiler; top: {'; '.join(top) if top else 'none'}); bound "
        f"from shapes {bound:.1f} ms a gate batch ({by})")
    return {**rec, "host_step_ms_b1": host_s / 64 * 1e3, "device_step_ms": busy,
            "bound_ms": bound, "bound_by": by}


def multiparty_schemes(dev, rng) -> dict:
    """E4 (CCS) and E5 (KMS) at 4 and 8 parties and E6 (both) at 16, full
    registry width (MULTI_SCHEME_SETS), torch ops that launch neither
    kernel: per set the keygen worker's key (its seconds, and the shares of
    build_sel, tgsw_encrypt and keyswitch_keygen) placed on the card
    through bridge.{ccs,kms}_cloud_key_from_numpy (perf_comp.take_key), its
    bytes equal to the ones from shapes; one NAND batch over all four input
    pairs through tools/perf_comp.row, with the counts at 0 before it:
    decrypted, its noise from the same batch (CCS: the std within
    CCS_NOISE_BAND of ccs_noise_std on the key and the wrong count under
    what that allows; KMS: 0 wrong and max |phase - ideal| < PHASE_BOUND),
    no kernel launch, the int8 products (CCS: steps x (P+3) + P), wall
    seconds, gates/s, peak memory, the host/device split of a CMux step on
    a 64-step chunk and the bound from shapes. One ``routes`` line a set;
    returns the records."""
    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.mk import ccs
    from torus_fhe_tpu_torch.tools import perf_comp

    routes = {}
    for i, (name, B) in enumerate(MULTI_SCHEME_SETS):
        params = P.PARAMETER_REGISTRY[name]()
        scheme = "ccs" if isinstance(params, P.SchemeParamsCCS) else "kms"
        parties = params.max_parties
        tag = "E6" if parties == 16 else "E4" if scheme == "ccs" else "E5"
        ck, sks, made, t_wait, t_card = perf_comp.take_key(name, params, dev, KEYGEN_WAIT_S)
        have, want_bytes = perf_comp.key_bytes(ck), perf_comp.scheme_key_bytes(params, parties)
        if have != want_bytes:
            raise AssertionError(f"{tag} {name}: {have} key bytes on the card, {want_bytes} from "
                                 "shapes")
        rec = perf_comp.row(scheme, ck, sks, B, 1, SEED + 600 + i, warmup=False)
        shares = ", ".join(f"{k} {v:.1f} s" for k, v in made["shares_s"].items())
        log(f"{tag} {name}", f"keygen worker {made['keygen_s']:.2f} s ({shares}; saved in "
            f"{made['save_s']:.2f} s, {made['npy_bytes'] / 1e9:.2f} GB of .npy), waited {t_wait:.2f} s, onto the card {t_card:.2f} s; key "
            f"on the card {have / 1e9:.3f} GB = {have} B (== from shapes); NAND B={B} (all four "
            f"input pairs) {rec['min_s']:.3f} s = {rec['gates_per_s']:.1f} gates/s, "
            f"{rec['steps']} CMux steps ({rec['step_ms']:.3f} ms a step); {rec['wrong']} wrong; "
            f"max |phase - ideal| {rec['phase_err_max']:.5f}, {rec['over_bound']} at or over "
            f"{perf_comp.PHASE_BOUND}, std {rec['boot_noise_std']:.5f}; blind_rotate "
            f"{rec['launches']['blind_rotate']}x, blind_rotate_sel "
            f"{rec['launches']['blind_rotate_sel']}x, int8 products {rec['int8_products']}; peak "
            f"memory {rec['peak_bytes'] / 1e9:.2f} GB; held to: {rec['gate']}"
            + (f" (expected over keys {rec['predicted_std_expected']:.5f})" if scheme == "ccs"
               else "") + f": {'met' if rec['correct'] and rec['noise_ok'] else 'NOT MET'} "
            f"[{SMI}]")
        if not (rec["correct"] and rec["noise_ok"]):
            raise AssertionError(f"{tag} {name}: {'; '.join(rec['fails'])}; {rec['gate']}")
        keys = [sk.lwe for sk in sks]
        gen = torch.Generator().manual_seed(SEED + 700 + i)
        pairs = torch.from_numpy(rng.permutation(np.arange(B) % 4)).to(dev)
        cx, cy = (mk.mk_encrypt(gen, keys, v, params) for v in (pairs >= 2, pairs % 2 == 1))
        temp = mk.mk_lwe_noiseless_trivial(ccs.MU, params.lwe, parties, (B,), device=dev) - cx - cy
        split = (ccs_split if scheme == "ccs" else kms_split)(ck, temp, B, tag, name, full=False)
        rec = {"route": "torch ops (F-block products, 32-bit)" if scheme == "ccs" else
               "torch ops (64-bit F-block scan, Toeplitz products)", **rec, "gates": 1,
               "keygen_s": made["keygen_s"], "keygen_shares_s": made["shares_s"],
               "key_to_card_s": t_card, "nand_s": rec["min_s"], **split}
        print(json.dumps({"routes": {name: rec}}), flush=True)
        routes[name] = rec
        del ck, sks, cx, cy, temp
        torch.cuda.empty_cache()
    return routes


def circuit_phase(name: str, kernel, fn):
    """Run ``fn``, one circuit phase, with the kernels' counts at 0 and each
    launch's CUDA events kept; record its bootstraps (ciphertexts
    blind-rotated: a MUX counts two), launches, wall seconds and the share of
    them the kernels ran, in CIRCUITS. ``kernel``: the one kernel the phase
    must launch (None: no launch at all). Returns fn's result."""
    from torus_fhe_tpu_torch.ops import cuda_rotate

    wrappers = {"blind_rotate": cuda_rotate.blind_rotate_cuda,
                "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda}
    torch.cuda.synchronize()
    reset_launches(cuda_rotate)
    cuda_rotate.launch_events = []
    try:
        out, wall = sync_time(fn)
    finally:
        events, cuda_rotate.launch_events = cuda_rotate.launch_events, None
    launches = {k: w.launches for k, w in wrappers.items()}
    rows = sum(w.rows for w in wrappers.values())
    if any(n for k, n in launches.items() if k != kernel) or (kernel and not launches[kernel]):
        raise AssertionError(f"{name}: launches {launches}, want only {kernel}")
    kernel_s = sum(start.elapsed_time(end) for start, end in events) / 1e3
    CIRCUITS[name] = {"bootstraps": rows, "launches": launches, "wall_s": wall,
                      "bootstraps_per_s": rows / wall, "kernel_s": kernel_s,
                      "kernel_share": kernel_s / wall}
    log(name, f"{rows} bootstraps, launches {launches}, {wall:.3f} s wall = "
        f"{rows / wall:.1f} bootstraps/s; kernels {kernel_s:.3f} s = {kernel_s / wall:.3f} of it")
    return out


def expect(tag: str, got, want) -> None:
    """Fail on any decrypted word that differs from the oracle's."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{tag}: shape {got.shape}, want {want.shape}")
    wrong = int((got != want).sum())
    if wrong:
        raise AssertionError(f"{tag}: {wrong} wrong words of {want.size}")
    log(tag, f"0 wrong of {want.size} against the oracle")


def network_sort(keys: np.ndarray, width: int, payload=None):
    """The bubble-sort network of the circuits in plain integers, column by
    column: a pair swaps unless the sign bit of a - b (mod 2^width) is set."""
    keys = keys.copy()
    payload = None if payload is None else payload.copy()
    mask = (1 << width) - 1
    for col in range(keys.shape[1]):
        for i in range(len(keys) - 1):
            for j in range(len(keys) - 1 - i):
                if not ((int(keys[j, col]) - int(keys[j + 1, col])) & mask) >> (width - 1) & 1:
                    keys[[j, j + 1], col] = keys[[j + 1, j], col]
                    if payload is not None:
                        payload[[j, j + 1], col] = payload[[j + 1, j], col]
    return keys, payload


def single_key_circuits(sk, ck, gen, rng) -> None:
    """C1 words, C2 KNN with its threshold tail, C3 conv2d / conv3d, at
    tfhe_128_tpu_fast on the main path's keys: every bootstrap launches
    blind_rotate.cu; every result is decrypted and held against numpy."""
    from torus_fhe_tpu_torch.apps import cnn, knn
    from torus_fhe_tpu_torch.boot import api
    from torus_fhe_tpu_torch.circuits import words

    enc = lambda v, w: words.int_encrypt(gen, sk, v, w)
    K = "blind_rotate"

    # C1. words: the reference's 32-bit adder, a comparator, a sort, a minimum
    w, B = C1_ADD
    a, b = rng.integers(0, 2**w, B), rng.integers(0, 2**w, B)
    ca, cb = enc(a, w), enc(b, w)
    cin = api.encrypt(gen, sk, torch.zeros(B, dtype=torch.bool))
    out = circuit_phase(f"C1 add {w}-bit B={B}", K,
                        lambda: words.add(ck, ca, cb, cin, w, with_carry=True))
    expect("C1 add", words.int_decrypt(sk, out, w + 1), a + b)
    w, B = C1_LESS
    a, b = rng.integers(0, 2**(w - 1), B), rng.integers(0, 2**(w - 1), B)
    ca, cb = enc(a, w), enc(b, w)
    out = circuit_phase(f"C1 less_than {w}-bit B={B}", K, lambda: words.less_than(ck, ca, cb, w))
    expect("C1 less_than", api.decrypt(sk, out).cpu().numpy(), a < b)
    w, m, B = C1_SORT
    keys = rng.integers(0, 2**(w - 1), (m, B))
    pay = np.repeat(np.arange(m)[:, None], B, axis=1)
    ck_words, cp_words = [enc(k, w) for k in keys], [enc(p, 3) for p in pay]
    sort_phase = f"C1 bubble_sort {m} words {w}-bit + payload, {B} sorts"
    got_w, (got_p,) = circuit_phase(sort_phase, K,
                                    lambda: words.bubble_sort(ck, ck_words, w, [cp_words]))
    want_k, want_p = network_sort(keys, w, pay)
    expect("C1 bubble_sort keys", [words.int_decrypt(sk, x, w) for x in got_w], want_k)
    expect("C1 bubble_sort payload", [words.int_decrypt(sk, x, 3) for x in got_p], want_p)
    # the MUX share of one compare-swap of the sort: its comparator, then its
    # four word MUXes (two of keys, two of payloads), each two rotates in turn
    a_less, t_less = sync_time(lambda: words.less_than(ck, ck_words[0], ck_words[1], w))
    pairs = [(ck_words[0], ck_words[1]), (ck_words[1], ck_words[0]),
             (cp_words[0], cp_words[1]), (cp_words[1], cp_words[0])]
    _, t_mux = sync_time(lambda: [words.mux_word(ck, a_less, x, y, w) for x, y in pairs])
    CIRCUITS[sort_phase]["mux_share"] = t_mux / (t_less + t_mux)
    log("C1 bubble_sort", f"one compare-swap: less_than {t_less * 1e3:.1f} ms, 4 word MUXes "
        f"{t_mux * 1e3:.1f} ms = {t_mux / (t_less + t_mux):.3f} of it")
    w, B = C1_MIN
    a, b = rng.integers(0, 2**(w - 1), B), rng.integers(0, 2**(w - 1), B)
    ca, cb = enc(a, w), enc(b, w)
    out = circuit_phase(f"C1 minimum {w}-bit B={B}", K, lambda: words.minimum(ck, ca, cb, w))
    expect("C1 minimum", words.int_decrypt(sk, out, w), np.minimum(a, b))

    # C2. KNN: one test row against the train rows, then the threshold tail
    rows, cols, w, k = C2_KNN
    tr_f, tr_l = rng.integers(0, 200, (rows, cols)), rng.integers(0, 2, rows)
    te_f = rng.integers(0, 200, (1, cols))
    feats, labs = knn.encrypt_dataset(gen, sk, tr_f, tr_l, w)
    test = enc(te_f[0], w)
    decision = circuit_phase(f"C2 knn_predict {rows}x{cols} {w}-bit k={k}", K,
                             lambda: knn.knn_predict(ck, feats, labs, test, k, w))
    bit = int(api.decrypt(sk, decision).item())
    expect("C2 knn_predict", bit, knn.plaintext_oracle(tr_f, tr_l, te_f, k, w)[0])
    tail = circuit_phase("C2 threshold_tail (3 of 5, {1,2,4})", None,
                         lambda: knn.threshold_tail(decision, sk, gen))
    expect("C2 threshold_tail", [r["bit"] for r in tail], [bit] * 4)

    # C3. CNN layers
    side, F, ks, w = C3_CONV2D
    image, kernels = rng.integers(0, 8, (side, side)), rng.integers(-2, 3, (F, ks, ks))
    cimg = enc(image, w)
    out = circuit_phase(f"C3 conv2d {side}x{side} {F} filters {ks}x{ks} {w}-bit", K,
                        lambda: cnn.conv2d(ck, cimg, kernels, w))
    expect("C3 conv2d", words.int_decrypt(sk, out, w),
           cnn.conv2d_reference(image, kernels) % (1 << w))
    side, F, ks, w = C3_CONV3D
    vol, kernels = rng.integers(0, 8, (side,) * 3), rng.integers(-2, 3, (F, ks, ks, ks))
    cvol = enc(vol, w)
    out = circuit_phase(f"C3 conv3d {side}^3 {F} filter {ks}^3 {w}-bit", K,
                        lambda: cnn.conv3d(ck, cvol, kernels, w))
    expect("C3 conv3d", words.int_decrypt(sk, out, w),
           cnn.conv3d_reference(vol, kernels) % (1 << w))


def mk_circuits(name: str, params, sks, ck, kernel: str, rng) -> None:
    """M1 (and at mk_2party_3gen M2, M3): the 3gen integer circuits, volume
    matching and multikey KNN with its threshold tail, on the set's key in
    its default form, each decrypted and held against numpy."""
    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.apps import cnn, knn, mk_knn
    from torus_fhe_tpu_torch.apps import volume_matching as vm
    from torus_fhe_tpu_torch.mk import gates3gen as g3
    from torus_fhe_tpu_torch.mk import keys3gen
    from torus_fhe_tpu_torch.ops import cuda_rotate

    keys = [sk.lwe for sk in sks]
    gen = torch.Generator().manual_seed(SEED + 100 + ck.parties)
    enc = lambda v, w: mk.mk_int_encrypt(gen, keys, v, w, params)
    dec = lambda x, w: mk.mk_int_decrypt(keys, x, w) % (1 << w)
    tag = f"{ck.parties} parties"
    spec = M1_SETS[name]
    key = ck.bk_fb if ck.bk_fb is not None else ck.bk_fb_sel
    geom = keys3gen.mk_fb_geometry(params, ck.parties)
    log(f"M1 bounds, {tag}", ", ".join(  # from shapes, for the batches of the adder and multiplier
        f"B={B}: {cuda_rotate.rotate_bound_ms(B, geom, key.numel())[0]:.2f} ms a launch"
        for B in sorted({spec["add"][1], spec["mul"][1]})))

    w, B = spec["add"]
    a, b = rng.integers(0, 2**w, B), rng.integers(0, 2**w, B)
    ca, cb = enc(a, w), enc(b, w)
    zero = g3.mk_word_constant(ck, ca, False)
    out = circuit_phase(f"M1 mk_add {w}-bit B={B}, {tag}", kernel,
                        lambda: g3.mk_add(ck, ca, cb, zero, w, with_carry=True))
    expect(f"M1 mk_add, {tag}", dec(out, w + 1), a + b)
    w, B = spec["mul"]
    a, b = rng.integers(0, 2**w, B), rng.integers(0, 2**w, B)
    ca, cb = enc(a, w), enc(b, w)
    zero = g3.mk_word_constant(ck, ca, False)
    out = circuit_phase(f"M1 mk_int_mul {w}-bit B={B}, {tag}", kernel,
                        lambda: g3.mk_int_mul(ck, ca, cb, zero, w))
    expect(f"M1 mk_int_mul, {tag}", dec(out, w), a * b % (1 << w))
    if "sort" in spec:
        w, m, B = spec["sort"]
        vals = rng.integers(0, 2**(w - 1), (m, B))
        cw = [enc(v, w) for v in vals]
        got = circuit_phase(f"M1 mk_bubble_sort {m} words {w}-bit, {B} sorts, {tag}", kernel,
                            lambda: g3.mk_bubble_sort(ck, cw, w))
        expect(f"M1 mk_bubble_sort, {tag}", [dec(x, w) for x in got], network_sort(vals, w)[0])
    if "conv" in spec:
        side, C, ks, w = spec["conv"]
        image, kernels = rng.integers(0, 4, (side, side)), rng.integers(0, 4, (C, ks, ks))
        cimg, cker = enc(image, w), enc(kernels, w)
        cimg = mk.MKLweSample(cimg.a.movedim(0, 2), cimg.b.movedim(0, 2))  # (H, W, width, ...)
        cker = mk.MKLweSample(cker.a.movedim(0, 3), cker.b.movedim(0, 3))  # (C, KH, KW, width, ...)
        zero1 = g3.mk_gate_constant(ck, torch.tensor(False))
        out = circuit_phase(f"M1 mk_conv2d {side}x{side} {C} channels {ks}x{ks} {w}-bit, {tag}",
                            kernel, lambda: g3.mk_conv2d(ck, cimg, cker, zero1, 1, w))
        out = mk.MKLweSample(out.a.movedim(3, 0), out.b.movedim(3, 0))
        expect(f"M1 mk_conv2d, {tag}", dec(out, w), cnn.conv2d_reference(image, kernels) % (1 << w))
    if ck.parties != 2:
        return

    # M2. volume matching
    nb, ns, w = M2_VOLUME
    buys, sells = rng.integers(1, 100, nb), rng.integers(1, 100, ns)
    cbuy, csell = enc(buys, w), enc(sells, w)
    zero = mk.mk_encrypt(gen, keys, torch.tensor(False), params)
    one = mk.mk_encrypt(gen, keys, torch.tensor(True), params)
    mb, ms = circuit_phase(f"M2 volume_match {nb} buys x {ns} sells {w}-bit, {tag}", kernel,
                           lambda: vm.volume_match(ck, cbuy, csell, zero, one, w))
    want_b, want_s = vm.match_oracle(buys, sells, w)
    expect(f"M2 volume_match, {tag}", np.concatenate([dec(mb, w), dec(ms, w)]),
           np.concatenate([want_b, want_s]))

    # M3. multikey KNN, every test row on one batch axis, then the tail per row
    rows, cols, w, k, T = M3_KNN
    tr_f, tr_l = rng.integers(0, 40, (rows, cols)), rng.integers(0, 2, rows)
    te_f = rng.integers(0, 40, (T, cols))
    feats, labs = mk_knn.mk_encrypt_dataset(gen, keys, tr_f, tr_l, w, params)
    tests = enc(te_f, w)
    decision = circuit_phase(f"M3 mk_knn_predict {rows}x{cols} {w}-bit k={k}, {T} test rows, "
                             f"{tag}", kernel,
                             lambda: mk_knn.mk_knn_predict_rows(ck, feats, labs, tests, k, w))
    bits = mk.mk_decrypt(keys, decision).cpu().numpy().astype(np.int64)
    expect(f"M3 mk_knn_predict, {tag}", bits, knn.plaintext_oracle(tr_f, tr_l, te_f, k, w))
    tails = circuit_phase(f"M3 mk_threshold_tail (ring {ck.parties * params.lwe_size}), {T} rows",
                          None, lambda: [mk_knn.mk_threshold_tail(
                              mk.MKLweSample(decision.a[i], decision.b[i]), keys, gen)
                              for i in range(T)])
    expect(f"M3 mk_threshold_tail, {tag}", [[r["bit"] for r in t] for t in tails],
           [[b] * 4 for b in bits])


def sharded_ops(rng, p5_dir: str) -> None:
    """P4: the party-sharded threshold decryption at N=1024, 3 of 5, against
    the sequential pair, and the tiny-parameter mesh dry run, on 8 slots.
    Writes the sample, the shares and the sequential pair's words to p5_dir
    for P5."""
    import os

    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.parallel import dryrun, make_mesh, sharded
    from torus_fhe_tpu_torch.rlwe import rlwe_encrypt, rlwe_keygen
    from torus_fhe_tpu_torch.threshold import decrypt as tdec
    from torus_fhe_tpu_torch.threshold import shares as tsh

    rp = P.thfhe_parameters_1024().rlwe
    g = torch.Generator().manual_seed(SEED + 11)
    rk = rlwe_keygen(g, rp, device=DEVICE)
    sh = tsh.share_secret(rk.key, 3, 5, g).subset_shares([1, 2, 4])
    ct = rlwe_encrypt(g, tdec.encode_bits(0xBEEF, rp.polynomial_degree, n_bits=16,
                                          device=DEVICE), 1e-3, rk, rp, device=DEVICE)
    mesh = make_mesh(n_batch=1, n_party=8, devices=mesh_devices(8))
    got = sharded.threshold_decrypt_sharded(ct.a, sh, [-1, 1, 1], 0.0,
                                            torch.Generator().manual_seed(SEED + 12), mesh)
    ref = tdec.final_decrypt(ct, tdec.partial_decrypt(ct, sh, 0.0, g))
    if not torch.equal(got, ref) or tdec.decode_bits(got, n_bits=16) != 0xBEEF:
        raise AssertionError("threshold_decrypt_sharded != final_decrypt(partial_decrypt) "
                             "or does not decode 0xBEEF")
    log("P4 threshold", "N=1024, 3 of 5, sd=0, 8 slots: sharded == sequential pair, decodes "
        "0xBEEF")
    np.savez(os.path.join(p5_dir, "threshold.npz"), a=ct.a.cpu(), shares=np.asarray(sh),
             signs=np.array([-1, 1, 1], np.int32), want=ref.cpu())
    dryrun.dryrun_multichip(mesh_devices(8))
    log("P4 dryrun", "dryrun_multichip on 8 slots: batch-sharded gate, sharded threshold "
        "decryption and the 4-party pipelined NAND pass")


def mesh_across_processes(p5_dir: str, pipe_ms: dict) -> dict:
    """P5: the mesh across processes (parallel/ after init_distributed), the
    ranks of each P5_GROUPS group spawned on the one card. The 8-party
    pipelined NAND (compact key) and the 2-party one (expanded key), one
    party a rank, each rank building its own shard only: the accumulators
    equal the one-process pipelined rotate on every rank, rank 0's NAND
    decrypts with 0 wrong, and every rank launches its kernel M times for
    the rotate and M times for the NAND. The party-sharded keyswitch and
    threshold decryption on 8 ranks, and the batch-sharded bootsAND on 2
    ranks and under NCCL on 1, word-equal to their one-process results (read
    from p5_dir). A rank that raises or hangs fails the run. Returns each
    kernel's launches over the NAND and gate paths of every rank."""
    import os

    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    mps = os.path.exists(os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps"))
    log("P5 device", f"compute mode {mode}; MPS {'on' if mps else 'off'} (no MPS: the ranks' "
        "contexts time-slice the card)")
    t0 = time.perf_counter()
    launches = {"blind_rotate": 0, "blind_rotate_sel": 0}
    for group, (backend, world, tasks) in enumerate(P5_GROUPS):
        t = time.perf_counter()
        ctx = mp.start_processes(p5_rank, args=(world, backend, p5_dir, group, tasks),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + P5_JOIN_S
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"P5 group {group} ({world} ranks, {backend}): not done "
                                       f"in {P5_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        recs = []
        for r in range(world):
            with open(os.path.join(p5_dir, f"group{group}_rank{r}.json")) as fh:
                recs.append(json.load(fh))
        for task in tasks:
            for r, rec in enumerate(recs):
                log(f"P5 {task} rank {r}/{world} {backend}", json.dumps(
                    {k: [round(x, 3) for x in v] if isinstance(v, list) else
                     round(v, 3) if isinstance(v, float) else v for k, v in rec[task].items()}))
            for rec in recs:
                for path in ("nand", "gate"):
                    for k, v in rec[task].get(f"launches_{path}", {}).items():
                        launches[k] += v
            if task in pipe_ms:
                walls = [statistics.median(rec[task]["rotate_ms"]) for rec in recs]
                log(f"P5 {task}", f"{world} ranks, one party each: pipelined rotate {max(walls):.3f} "
                    f"ms (median of {PIPE_REPS}, slowest rank; ranks {min(walls):.3f}-"
                    f"{max(walls):.3f}) vs {pipe_ms[task]:.3f} ms in one process (P2/P3), ratio "
                    f"{max(walls) / pipe_ms[task]:.3f}; == one-process accumulators on every "
                    f"rank; NAND 0 wrong")
        log(f"P5 group {group}", f"{world} ranks ({backend}) {', '.join(tasks)}: "
            f"{time.perf_counter() - t:.1f} s with spawn")
    log("P5", f"{time.perf_counter() - t0:.1f} s; launches on the NAND and gate paths of every "
        f"rank: {json.dumps(launches)}")
    return launches


def p5_rank(index: int, world: int, backend: str, p5_dir: str, group: int, tasks) -> None:
    """One rank of a P5 group, spawned: joins the group through a file store
    in p5_dir, runs ``tasks`` on its card and writes their records to
    p5_dir/group<group>_rank<index>.json. Raises on the first failed check."""
    import os

    from torus_fhe_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    pmesh.init_distributed(f"file://{os.path.join(p5_dir, f'store{group}')}", world, index,
                           backend=backend, timeout=P5_COLLECTIVE_S)
    try:
        rec = {}
        for task in tasks:
            fn = {"keyswitch": p5_keyswitch, "threshold": p5_threshold, "gate": p5_gate}
            rec[task] = fn[task](p5_dir) if task in fn else p5_pipeline(task, p5_dir)
        with open(os.path.join(p5_dir, f"group{group}_rank{index}.json"), "w") as fh:
            json.dump(rec, fh)
    finally:
        torch.distributed.destroy_process_group()


def p5_pipeline(name: str, p5_dir: str) -> dict:
    """A P5 rank's pipelined rotate and NAND at ``name``: its own party's
    shard only, the rotate == the one-process accumulators, the NAND == the
    one-process words (rank 0: 0 wrong), M launches of the form's kernel
    each; the rotate timed PIPE_REPS times from a barrier."""
    import os

    from torus_fhe_tpu_torch import mk
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.lwe import LweKey
    from torus_fhe_tpu_torch.mk import boot3gen, gates3gen, keys3gen
    from torus_fhe_tpu_torch.mk.samples import MKLweSample
    from torus_fhe_tpu_torch.parallel import make_mesh, mk_pipeline
    from torus_fhe_tpu_torch.parallel.mesh import process_rank

    d = np.load(os.path.join(p5_dir, f"{name}.npz"))
    params = P.PARAMETER_REGISTRY[name]()
    parties, M, me = params.max_parties, MICROBATCHES, process_rank()
    expanded = PIPE_FORM[name] == "expanded"
    kernel = "blind_rotate" if expanded else "blind_rotate_sel"
    want_counts = {"blind_rotate": M if expanded else 0, "blind_rotate_sel": 0 if expanded else M}
    mesh = make_mesh(n_batch=1, n_party=parties)
    build = mk_pipeline.build_sharded_mk_fb if expanded else mk_pipeline.build_sharded_mk_sel
    shards, t_build = sync_time(lambda: build(d["samples"], params, parties, mesh))
    if [s is not None for s in shards] != [p == me for p in range(parties)]:
        raise AssertionError(f"{name}: rank {me} holds the shards of parties "
                             f"{[p for p, s in enumerate(shards) if s is not None]}")
    dev = shards[me].device
    bara, barb = torch.from_numpy(d["bara"]).to(dev), torch.from_numpy(d["barb"]).to(dev)
    mu32 = boot3gen.hi_word(gates3gen.MU)

    def rotate():
        return mk_pipeline.mk_blind_rotate_pipelined(shards, bara, barb, mu32, params, parties,
                                                     mesh, M)

    acc, counts_rotate, _ = launched(rotate)
    if counts_rotate != want_counts:
        raise AssertionError(f"{name} rank {me}: rotate launches {counts_rotate}, want {want_counts}")
    if not torch.equal(acc.cpu(), torch.from_numpy(d["pipe"])):
        raise AssertionError(f"{name} rank {me}: pipelined accumulators != one-process ones")
    ck = keys3gen.MKCloudKey(torch.from_numpy(d["ks_mat"]).to(dev), parties, params)
    t = MKLweSample(torch.from_numpy(d["t_a"]).to(dev), torch.from_numpy(d["t_b"]).to(dev))
    out, counts_nand, t_nand = launched(lambda: mk_pipeline.mk_bootstrap_pipelined(
        ck, shards, gates3gen.MU, t, mesh, M))
    if counts_nand != want_counts:
        raise AssertionError(f"{name} rank {me}: NAND launches {counts_nand}, want {want_counts}")
    if not (np.array_equal(out.a.cpu().numpy(), d["out_a"])
            and np.array_equal(out.b.cpu().numpy(), d["out_b"])):
        raise AssertionError(f"{name} rank {me}: pipelined NAND != the one-process words")
    wrong = None
    if me == 0:
        keys = [LweKey(k.to(dev)) for k in torch.from_numpy(d["keys"])]
        want = ~(torch.from_numpy(d["x"]) & torch.from_numpy(d["y"])).to(dev)
        wrong = int(mk.mk_decrypt(keys, out).ne(want).sum())
        if wrong:
            raise AssertionError(f"{name}: pipelined NAND across ranks, {wrong} wrong")
    walls = []
    for _ in range(PIPE_REPS):
        torch.distributed.barrier()
        walls.append(sync_time(rotate)[1] * 1e3)
    return {"form": PIPE_FORM[name], "B": int(barb.shape[0]), "M": M,
            "shard_GB": shards[me].numel() / 1e9, "build_s": t_build,
            "launches_rotate": counts_rotate, "launches_nand": counts_nand, "nand_s": t_nand,
            "wrong": wrong, "rotate_ms": walls, "kernel": kernel,
            "peak_GB": torch.cuda.max_memory_allocated() / 1e9}


def p5_keyswitch(p5_dir: str) -> dict:
    """A P5 rank's part of mk_keyswitch_sharded at 8 parties, one party
    slot a rank: == mk_keyswitch's words (from P4) on every rank."""
    import os

    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.lwe import LweSample
    from torus_fhe_tpu_torch.mk import keys3gen
    from torus_fhe_tpu_torch.parallel import make_mesh, sharded
    from torus_fhe_tpu_torch.parallel.mesh import rank_device

    d = np.load(os.path.join(p5_dir, "mk_8party_3gen.npz"))
    params = P.PARAMETER_REGISTRY["mk_8party_3gen"]()
    dev = rank_device()
    ck = keys3gen.MKCloudKey(torch.from_numpy(d["ks_mat"]).to(dev), 8, params)
    mesh = make_mesh(n_batch=1, n_party=8)
    tables = sharded.mk_ks_tables_sharded(ck, mesh)
    u = LweSample(torch.from_numpy(d["u_a"]).to(dev), torch.from_numpy(d["u_b"]).to(dev))
    got, wall = sync_time(lambda: sharded.mk_keyswitch_sharded(ck, tables, u, mesh))
    if not (np.array_equal(got.a[..., :8, :].cpu().numpy(), d["ks_a"])
            and np.array_equal(got.b.cpu().numpy(), d["ks_b"])):
        raise AssertionError("mk_keyswitch_sharded across 8 ranks != mk_keyswitch")
    return {"tables_held": sum(t is not None for t in tables), "s": wall}


def p5_threshold(p5_dir: str) -> dict:
    """A P5 rank's part of threshold_decrypt_sharded at N=1024, 3 of 5,
    sd=0, one party slot a rank, each rank's generator seeded apart: the
    sequential pair's words (from P4) on every rank, decoding 0xBEEF."""
    import os

    from torus_fhe_tpu_torch.parallel import make_mesh, sharded
    from torus_fhe_tpu_torch.parallel.mesh import process_rank, rank_device
    from torus_fhe_tpu_torch.threshold import decrypt as tdec

    d = np.load(os.path.join(p5_dir, "threshold.npz"))
    dev = rank_device()
    mesh = make_mesh(n_batch=1, n_party=torch.distributed.get_world_size())
    gen = torch.Generator().manual_seed(SEED + 100 + process_rank())
    got, wall = sync_time(lambda: sharded.threshold_decrypt_sharded(
        torch.from_numpy(d["a"]).to(dev), torch.from_numpy(d["shares"]), d["signs"], 0.0, gen,
        mesh))
    if not np.array_equal(got.cpu().numpy(), d["want"]) or tdec.decode_bits(got, n_bits=16) != 0xBEEF:
        raise AssertionError("threshold_decrypt_sharded across ranks != the sequential pair or "
                             "does not decode 0xBEEF")
    return {"s": wall}


def p5_gate(p5_dir: str) -> dict:
    """A P5 rank's part of the batch-sharded bootsAND at tfhe_128_tpu_fast,
    B=MAIN_BATCH, one batch slot a rank: the single-device gate's words on
    every rank, one blind_rotate launch a rank."""
    import os

    from torus_fhe_tpu_torch.boot import gates
    from torus_fhe_tpu_torch.lwe import LweSample
    from torus_fhe_tpu_torch.parallel import make_mesh
    from torus_fhe_tpu_torch.parallel import mesh as pmesh
    from torus_fhe_tpu_torch.utils import serialize

    dev = pmesh.rank_device()
    ck = serialize.load_cloud_key(os.path.join(p5_dir, "fast_cloud.key"), device=dev)
    d = np.load(os.path.join(p5_dir, "gate.npz"))
    mesh = make_mesh(n_batch=torch.distributed.get_world_size())
    x, y = (LweSample(torch.from_numpy(d[f"{v}_a"]).to(dev), torch.from_numpy(d[f"{v}_b"]).to(dev))
            for v in "xy")
    xs, ys = pmesh.shard_lwe_batch(x, mesh), pmesh.shard_lwe_batch(y, mesh)
    keys = pmesh.replicate_cloud_key(ck, mesh)
    out, counts, wall = launched(lambda: pmesh.run_batch_sharded(gates.gate_and, keys, xs, ys,
                                                                 mesh=mesh))
    if counts != {"blind_rotate": 1, "blind_rotate_sel": 0}:
        raise AssertionError(f"batch-sharded gate across ranks: launches {counts}, want one of "
                             "blind_rotate a rank")
    if not (np.array_equal(out.a.cpu().numpy(), d["out_a"])
            and np.array_equal(out.b.cpu().numpy(), d["out_b"])):
        raise AssertionError("batch-sharded gate_and across ranks != the single-device gate")
    walls = [sync_time(lambda: pmesh.run_batch_sharded(gates.gate_and, keys, xs, ys,
                                                       mesh=mesh))[1] for _ in range(3)]
    return {"B": int(d["out_b"].shape[0]), "launches_gate": counts, "s": wall,
            "gates_per_s": int(d["out_b"].shape[0]) / statistics.median(walls)}


def counted(fn, want=None):
    """(fn's result, blind_rotate launches, wall seconds) of one call of fn,
    with the kernels' counts at 0 just before it and read just after. The
    compact-key kernel must not launch; ``want``, where given, is the exact
    count of blind_rotate launches."""
    out, counts, wall = launched(fn)
    n = counts["blind_rotate"]
    if counts["blind_rotate_sel"] or (want is not None and n != want):
        raise AssertionError(f"launches: blind_rotate {n} (want {want}), blind_rotate_sel "
                             f"{counts['blind_rotate_sel']} (want 0)")
    return out, n, wall


def peak_bytes(fn):
    """(fn's result, device bytes allocated at the peak of one call above
    what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def wrap_diff(x, y) -> int:
    """The largest |x - y| mod 2^32, taken the short way round the torus."""
    d = (x.cpu().to(torch.int64) - y.cpu().to(torch.int64)) % 2**32
    return int(torch.minimum(d, 2**32 - d).max())


def fft_bound_ms(rows: int, N: int):
    """The limb FFT product of ``rows`` pairs of N-coefficient 32-bit polys:
    6 complex128 FFTs a row (both limbs of both operands forward, two
    inverse) of 5 N log2 N flops at the card's float64 rate, against the two
    inputs and the output read or written once (int32)."""
    from torus_fhe_tpu_torch.ops import cuda_rotate

    return cuda_rotate.bound_ms(6 * rows * 5 * N * np.log2(N), cuda_rotate.FP64_OPS_PER_S,
                                3 * rows * N * 4)


def exact_product(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """Exact negacyclic a (*) b mod 2^32 of uniform 32-bit polys (host):
    the exact host products of a's two 16-bit halves."""
    from torus_fhe_tpu_torch.ops import hostmath

    a = a.astype(np.int64)
    lo = ((a + (1 << 15)) & 0xFFFF) - (1 << 15)
    with np.errstate(over="ignore"):
        out = (hostmath.negacyclic_polymul_host(lo, b, 32).astype(np.int64)
               + (hostmath.negacyclic_polymul_host((a - lo) >> 16, b, 32).astype(np.int64) << 16))
    return torch.from_numpy(out.astype(np.int32))


def threshold_aux(sk, ck, gen, rng, dev) -> int:
    """D1-D3 at tfhe_128_tpu_fast on the main path's keys: public-key
    encryption and public sampling (their gates launch blind_rotate.cu),
    LWE -> RLWE packing, additive and Shamir key splitting and the limb FFT
    product of huge rings. Every result is decrypted; one wrong word fails
    the run. Returns the blind_rotate launches of their paths."""
    import dataclasses

    from torus_fhe_tpu_torch.boot import api, gates, pack, public_sample
    from torus_fhe_tpu_torch.core.params import RLweParams
    from torus_fhe_tpu_torch.core.torus import encode_message
    from torus_fhe_tpu_torch.lwe import LweSample, lwe_phase
    from torus_fhe_tpu_torch.ops import cuda_rotate, hostmath, poly
    from torus_fhe_tpu_torch.rlwe import extract_lwe_key, rlwe_encrypt, rlwe_keygen, rlwe_phase
    from torus_fhe_tpu_torch.threshold import additive, pk, shamir
    from torus_fhe_tpu_torch.threshold import decrypt as tdec

    fast, B = sk.params, MAIN_BATCH
    N = fast.rlwe_polynomial_degree
    eighth = int(encode_message(1, 8))
    bits = lambda *shape: torch.from_numpy(rng.integers(0, 2, shape).astype(bool)).to(dev)
    dec = lambda ct: api.decrypt(sk, ct).cpu().numpy()
    launches = 0

    # D1. public-key encryption: 20 encryptions of zero, subset sums, a gate
    t0 = time.perf_counter()
    pub, t_keygen = sync_time(lambda: pk.public_keygen(gen, sk.key, fast.lwe_noise_stddev))
    x, y = bits(B), bits(B)
    cx, cy = pk.public_encrypt(gen, pub, x), pk.public_encrypt(gen, pub, y)
    expect("D1 public_encrypt", np.concatenate([dec(cx), dec(cy)]),
           torch.cat([x, y]).cpu().numpy())
    and_pk, n, t_and = counted(lambda: gates.gate_and(ck, cx, cy), want=1)
    launches += n
    expect("D1 gate_and on public-key ciphertexts", dec(and_pk), (x & y).cpu().numpy())
    # public sampling: fresh encryptions of new messages from the seed batch cx
    msgs = bits(B)
    sampled, n, t_sample = counted(lambda: public_sample.public_sample(ck, cx, msgs), want=1)
    launches += n
    expect("D1 public_sample", dec(sampled), msgs.cpu().numpy())
    zero, n, _ = counted(lambda: public_sample.fresh_zero(ck, cy), want=1)
    launches += n
    expect("D1 fresh_zero", dec(zero), np.zeros(B, bool))
    err = lambda ct, want: ((lwe_phase(ct, sk.key) - torch.where(want, eighth, -eighth))
                            .to(torch.int32).double() / 2**32).std().item()
    z_std, g_std = err(zero, torch.zeros_like(x)), err(and_pk, x & y)
    if abs(z_std / g_std - 1) > FRESH_NOISE_BAND:
        raise AssertionError(f"D1: fresh_zero noise std {z_std:.6f} is {z_std / g_std:.3f}x a "
                             f"gate's {g_std:.6f}, not within {FRESH_NOISE_BAND:.0%}")
    # rlwe_extract_sample_at: coefficient `pos` of B ring samples as LWE samples
    rk = rlwe_keygen(gen, fast.rlwe, device=dev)
    positions = (0, 1, N - 1)
    ring_bits = torch.from_numpy(rng.integers(0, 2, (B, len(positions))).astype(bool))
    mu = torch.zeros((B, N), dtype=torch.int32)
    mu[:, list(positions)] = torch.where(ring_bits, eighth, -eighth).to(torch.int32)
    ring = rlwe_encrypt(gen, mu, fast.bs_noise_stddev, rk, fast.rlwe, (B,), device=dev)
    for i, pos in enumerate(positions):
        got = lwe_phase(public_sample.rlwe_extract_sample_at(ring, pos), extract_lwe_key(rk)) > 0
        expect(f"D1 rlwe_extract_sample_at {pos}", got.cpu().numpy(), ring_bits[:, i].numpy())
    AUX["D1 public key, public sampling"] = {
        "B": B, "public_keygen_s": t_keygen, "gate_and_s": t_and, "public_sample_s": t_sample,
        "fresh_zero_noise_std": z_std, "gate_noise_std": g_std, "ratio": z_std / g_std,
        "wall_s": time.perf_counter() - t0}
    log("D1", f"B={B}: public-key keygen {t_keygen:.3f} s, gate_and on public-key ciphertexts "
        f"{t_and:.3f} s, public_sample {t_sample:.3f} s (1 launch each); fresh_zero noise std "
        f"{z_std:.6f} = {z_std / g_std:.3f}x a gate's {g_std:.6f}; extract at {positions}")

    # D2. packing: 4 x 512 gate outputs into 4 ring samples of the fast set's ring
    t0 = time.perf_counter()
    l, lb = PACK_GADGET
    pkey, t_pkg = sync_time(lambda: pack.packing_keyswitch_keygen(
        gen, fast.bs_noise_stddev, sk.key, rk, fast.rlwe, l, lb, device=dev))
    M, m = PACK_SHAPE
    lwe_in = LweSample(torch.cat([and_pk.a, sampled.a])[:M * m].reshape(M, m, -1),
                       torch.cat([and_pk.b, sampled.b])[:M * m].reshape(M, m))
    want = torch.cat([x & y, msgs])[:M * m].reshape(M, m)
    packed, peak = peak_bytes(lambda: pack.pack_lwes(pkey, lwe_in, N))
    phase = rlwe_phase(packed, rk)[..., :m]
    expect("D2 pack_lwes", (phase > 0).cpu().numpy(), want.cpu().numpy())
    pack_noise = (phase - lwe_phase(lwe_in, sk.key)).to(torch.int32).double().abs() / 2**32
    if pack_noise.max().item() >= 1 / 16:
        raise AssertionError(f"D2: packing noise max {pack_noise.max().item():.5f} >= 1/16")
    pack_ms = event_ms(lambda: pack.pack_lwes(pkey, lwe_in, N), 3)
    cpu_key = dataclasses.replace(pkey, kernels=pkey.kernels.cpu())
    cpu_out, t_cpu = sync_time(lambda: pack.pack_lwes(
        cpu_key, LweSample(lwe_in.a[0].cpu(), lwe_in.b[0].cpu()), N))
    if not torch.equal(cpu_out.a, packed.a[0].cpu()):
        raise AssertionError("D2: pack_lwes on the card != on the CPU")
    CL, R = pkey.kernels.shape[:2]
    pack_bound = cuda_rotate.bound_ms(2 * M * CL * R * N * N, cuda_rotate.INT8_OPS_PER_S,
                                      pkey.kernels.numel() + lwe_in.a.numel() * 4
                                      + lwe_in.b.numel() * 4 + packed.a.numel() * 4)
    AUX["D2 pack_lwes"] = {
        "packed": M, "lwes_each": m, "key_shape": list(pkey.kernels.shape),
        "key_mb": pkey.kernels.numel() / 1e6, "keygen_s": t_pkg, "ms": pack_ms,
        "peak_mb": peak / 1e6, "bound_ms": pack_bound[0], "bound_by": pack_bound[1],
        "cpu_one_s": t_cpu, "noise_max": pack_noise.max().item(),
        "noise_std": pack_noise.std().item(), "wall_s": time.perf_counter() - t0}
    log("D2 pack_lwes", f"{M} x {m} gate outputs -> {M} ring samples (k=2, N={N}, l={l}, "
        f"2^{lb}): 0 wrong, packing noise max {pack_noise.max().item():.5f} (< 1/16); keygen "
        f"{t_pkg:.2f} s, key {tuple(pkey.kernels.shape)} int8 = "
        f"{pkey.kernels.numel() / 1e6:.1f} MB; pack {pack_ms:.3f} ms on the card (bound "
        f"{pack_bound[0]:.4f} ms, {pack_bound[1]}), peak {peak / 1e6:.1f} MB; == the CPU's "
        f"words for one ciphertext ({t_cpu:.2f} s there)")
    del pkey, packed, lwe_in, cpu_out, ring

    # D3. additive splits of the LWE key, decoding the public-key AND
    t0 = time.perf_counter()
    fronts = {}
    for p in ADDITIVE_PARTIES:
        sh = additive.split_lwe_key(gen, sk.key, p)
        if not torch.equal(sh.shares.sum(0, dtype=torch.int32), sk.key.key):
            raise AssertionError(f"D3: {p} additive shares do not sum to the key")
        g = torch.Generator().manual_seed(SEED + p)
        decode = lambda bnd: (additive.combine(and_pk, additive.lwe_partial_decrypt(
            and_pk, sh, bnd, g)) > 0).cpu().numpy()
        expect(f"D3 additive {p} of {p}, bound 2^-10", decode(ADDITIVE_BOUND),
               (x & y).cpu().numpy())
        # the bound sweep 1.0 -> 1e-2, halving as the repository's other sweeps
        # do, down to 2^-7 (below 1e-2) so that it brackets the frontier
        sweep = [2.0**-i for i in range(8)]
        fronts[p] = additive.max_tolerable_bound(
            lambda bnd: bool((decode(bnd) == (x & y).cpu().numpy()).all()), sweep)
        if not 0 < fronts[p] < sweep[0]:  # decodes at some bound, and smudging of 1.0 breaks it
            raise AssertionError(f"D3: {p} of {p} additive frontier {fronts[p]} not inside the "
                                 f"sweep {sweep}")
    # TlweTwoTwo: ring N = 2^20, k = 1, 2 of 2, 16 bits
    big = RLweParams(HUGE_RING, 1, 32)
    g = torch.Generator().manual_seed(SEED + 20)
    rkb = rlwe_keygen(g, big, device=dev)
    value = int(rng.integers(0, 1 << 16))
    ctb = rlwe_encrypt(g, tdec.encode_bits(value, HUGE_RING, n_bits=16), 1e-7, rkb, big,
                       device=dev)
    shb = additive.split_rlwe_key(g, rkb, 2)
    parts, t_part = sync_time(lambda: additive.rlwe_partial_decrypt(ctb, shb, 1e-4, g))
    got = tdec.decode_bits(additive.combine(ctb, parts), n_bits=16)
    expect(f"D3 TlweTwoTwo N=2^{HUGE_RING.bit_length() - 1}", got, value)
    del rkb, ctb, shb, parts
    # the FFT product: card against CPU and the exact product at 2^20 (uniform
    # 32-bit inputs), card == exact at the 8-party tail's ring (small shares)
    fft = {}
    a, b = rand_torus(rng, (2, HUGE_RING), 32), rand_torus(rng, (2, HUGE_RING), 32)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    card, peak = peak_bytes(lambda: poly.negacyclic_polymul_fft64(ta, tb))
    d_cpu = wrap_diff(card, poly.negacyclic_polymul_fft64(ta.cpu(), tb.cpu()))
    d_exact = wrap_diff(card, exact_product(a, b))
    if max(d_cpu, d_exact) > FFT_TOL:
        raise AssertionError(f"D3: FFT product at 2^20: |card - cpu| {d_cpu}, |card - exact| "
                             f"{d_exact}, above {FFT_TOL}")
    fft[HUGE_RING] = {"rows": 2, "ms": event_ms(lambda: poly.negacyclic_polymul_fft64(ta, tb), 5),
                      "peak_mb": peak / 1e6, "max_diff_cpu": d_cpu, "max_diff_exact": d_exact}
    s = rand_torus(rng, (3, 1, TAIL_RING), 32) % 3 - 1  # shares of a binary key: small
    r = rand_torus(rng, (1, TAIL_RING), 32)
    ts, tr = torch.from_numpy(s).to(dev), torch.from_numpy(r).to(dev).expand(3, 1, TAIL_RING)
    card, peak = peak_bytes(lambda: poly.negacyclic_polymul_fft64(ts, tr))
    d_exact = max_diff(card.cpu(), torch.from_numpy(
        hostmath.negacyclic_polymul_host(s, np.broadcast_to(r, s.shape), 32)))
    if d_exact:
        raise AssertionError(f"D3: FFT product at N={TAIL_RING} != exact: max |diff| {d_exact}")
    fft[TAIL_RING] = {"rows": 3, "ms": event_ms(lambda: poly.negacyclic_polymul_fft64(ts, tr), 20),
                      "peak_mb": peak / 1e6, "max_diff_exact": d_exact}
    for ring_n, rec in fft.items():
        rec["bound_ms"], rec["bound_by"] = fft_bound_ms(rec["rows"], ring_n)
        diffs = {k: v for k, v in rec.items() if k.startswith("max_diff")}
        log("D3 FFT product", f"N={ring_n}, {rec['rows']} rows: {rec['ms']:.4f} ms on the card "
            f"(bound {rec['bound_ms']:.4f} ms, {rec['bound_by']}), peak "
            f"{rec['peak_mb']:.1f} MB; {diffs} (tolerance {FFT_TOL})")
    # Shamir 3 of 5 over Z_8191, reconstructed from two subsets
    key_bits = sk.key.key.cpu().numpy()
    shards = shamir.split_key(key_bits, 3, 5, seed=SEED)
    for use in ([0, 1, 2], [4, 1, 3]):
        expect(f"D3 Shamir 3 of 5 from {use}", shamir.reconstruct_key(shards, use), key_bits)
    AUX["D3 splits, huge rings"] = {
        "additive_parties": list(ADDITIVE_PARTIES), "max_tolerable_bound": fronts,
        "huge_ring_partials_s": t_part, "fft": fft, "wall_s": time.perf_counter() - t0}
    log("D3", f"additive {ADDITIVE_PARTIES}: max tolerable bound {fronts}; TlweTwoTwo N={HUGE_RING} "
        f"partials {t_part:.3f} s, 16 bits decoded; Shamir 3 of 5 from two subsets")
    return launches


def cli_phase(rng) -> int:
    """D4: the CLI (python -m torus_fhe_tpu_torch) on the card, in a
    temporary directory, through cli.main(argv): keygen, encrypt, eval and,
    decrypt, convert, tlwetn and knn on a synthetic CSV; --help once as a
    subprocess. Returns the blind_rotate launches of eval, convert and knn."""
    import contextlib
    import io
    import os
    import tempfile

    from torus_fhe_tpu_torch import cli

    t0 = time.perf_counter()
    launches, times = 0, {}

    def run(want, *argv):
        nonlocal launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, n, times[argv[0]] = counted(lambda: cli.main(list(argv)), want)
        if rc != 0:
            raise AssertionError(f"D4 {' '.join(argv)}: exit code {rc}\n{buf.getvalue()[-2000:]}")
        launches += n
        return buf.getvalue().strip().splitlines()

    x, y = (int(v) for v in rng.integers(0, 2**32, 2))
    rows, tests, cols, w, k = CLI_KNN
    with tempfile.TemporaryDirectory() as tmp:
        f = lambda name: os.path.join(tmp, name)
        keys = ["--secret", f("secret.key.npz"), "--cloud", f("cloud.key.npz")]
        run(0, "keygen", "--params", CLI_PARAMS, *keys, "--seed", str(SEED))
        run(0, "encrypt", str(x), "--secret", f("secret.key.npz"), "--out", f("a.npz"))
        run(0, "encrypt", str(y), "--secret", f("secret.key.npz"), "--out", f("b.npz"),
            "--seed", "2")
        run(1, "eval", "and", f("a.npz"), f("b.npz"), "--cloud", f("cloud.key.npz"),
            "--out", f("c.npz"))
        expect("D4 eval and", int(run(0, "decrypt", f("c.npz"), "--secret",
                                      f("secret.key.npz"))[-1]), x & y)
        out = run(1, "convert", str(x), str(y), *keys)
        expect("D4 convert", sum("[OK]" in ln for ln in out), 4)
        out = run(0, "tlwetn", "3", "5", "1", "2", "4")  # the sweep 0.0625 -> 1e-3:
        # the smallest four bounds must decode; the largest lie at the smudging frontier
        expect("D4 tlwetn", ["-> 13452 [OK]" in ln for ln in out[-4:]], [True] * 4)
        data = np.concatenate([np.arange(rows + tests)[:, None],
                               rng.integers(0, 200, (rows + tests, cols)),
                               rng.integers(0, 2, (rows + tests, 1))], axis=1)
        np.savetxt(f("cardio.csv"), data, fmt="%d", delimiter=",",
                   header="id," + ",".join(f"c{i}" for i in range(cols)) + ",label", comments="")
        res = json.loads(run(None, "knn", f("cardio.csv"), "--params", CLI_PARAMS, "--k", str(k),
                             "--width", str(w), "--shift", "0", "--train-rows", str(rows),
                             "--test-rows", str(tests), "--seed", str(SEED))[-1])
        expect("D4 knn", res["predictions"], res["oracle"])
        expect("D4 knn threshold tail", [[r["bit"] for r in t] for t in res["threshold_tail"]],
               [[p] * 4 for p in res["predictions"]])
    repo = os.path.dirname(os.path.abspath(__file__))
    helped = subprocess.run([sys.executable, "-m", "torus_fhe_tpu_torch", "--help"], cwd=repo,
                            capture_output=True, text=True, timeout=300)
    if helped.returncode or not all(c in helped.stdout for c in ("keygen", "tlwetn", "--device")):
        raise AssertionError(f"D4 --help: exit code {helped.returncode}\n{helped.stderr[-2000:]}")
    AUX["D4 cli"] = {"seconds": times, "launches": launches, "wall_s": time.perf_counter() - t0}
    log("D4 cli", f"{CLI_PARAMS}: " + ", ".join(f"{c} {s:.2f} s" for c, s in times.items())
        + f"; blind_rotate launched {launches}x; --help as a subprocess")
    return launches


def noise_single_key(dev, rng, routes) -> dict:
    """N1: utils/noise.measure_single_key at tfhe_128_tpu_fast, N1_TRIALS
    trials, with its own keygen: 0 wrong, boot-noise std within NOISE_BAND
    of N1_ENVELOPE, both rounded-phase classes 0, and 2 launches of
    blind_rotate.cu (the gate and the bootstrapped True)."""
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.utils import noise

    rep, counts, wall = launched(lambda: noise.measure_single_key(
        torch.Generator().manual_seed(SEED + 500), P.tfhe_parameters_128_tpu_fast(),
        trials=N1_TRIALS, device=dev))
    log("N1 measure_single_key", f"tfhe_128_tpu_fast, {N1_TRIALS} trials: {wall:.2f} s with its "
        f"keygen; launches {counts}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if counts != {"blind_rotate": 2, "blind_rotate_sel": 0}:
        raise AssertionError(f"N1: launches {counts}, want 2 of blind_rotate")
    check_report("N1 tfhe_128_tpu_fast", rep, N1_ENVELOPE, classes=True)
    routes["tfhe_128_tpu_fast noise"] = {"trials": rep.trials, "wall_s": wall,
                                         "gate_s": rep.bootstrap_wall_s, **counts}
    torch.cuda.empty_cache()
    return counts


def noise_3gen_public(dev, rng, routes) -> dict:
    """N2 through the public entry: utils/noise.measure_multikey at
    mk_2party_3gen with its own keygen, N2_TRIALS messages, in the default
    form (the expanded key): 3 launches of its kernel (blind_rotate.cu),
    and the report held as N2 holds the one on multikey()'s key."""
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.utils import noise

    from torus_fhe_tpu_torch.mk import keys3gen

    name, params = "mk_2party_3gen", P.PARAMETER_REGISTRY["mk_2party_3gen"]()
    rep, counts, wall = launched(lambda: noise.measure_multikey(
        torch.Generator().manual_seed(SEED + 501), params, 2, trials=N2_TRIALS[name], device=dev))
    log(f"N2 measure_multikey {name}", f"{wall:.2f} s with its keygen; launches {counts}")
    kernel = "blind_rotate" if keys3gen.default_forms(params, 2) == ("fblock",) else \
        "blind_rotate_sel"
    if counts[kernel] != 3 or sum(counts.values()) != 3:
        raise AssertionError(f"N2 measure_multikey: launches {counts}, want 3 of {kernel}")
    check_report(f"N2 measure_multikey {name}", rep, NOISE_ENVELOPE[name],
                 pre_ks_jax=PRE_KS_JAX[name])
    torch.cuda.empty_cache()
    return counts


def exact_route(dev, rng, routes) -> dict:
    """N3: utils/noise.measure_multikey at N3_SET with fast_form=False, the
    exact 64-bit route at full width (the compact lines of the raw samples,
    the torch-op scan; JAX's conv form), with its own keygen and the cloud
    key through ``cache_path``: 0 wrong, boot-noise std within NOISE_BAND of
    N3_ENVELOPE, no kernel launch. Then the key loaded from that file times
    a 64-step chunk of its rotate, host against device, beside the bound
    from shapes. Adds a ``routes`` record."""
    import os
    import tempfile

    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.mk import keys3gen
    from torus_fhe_tpu_torch.ops import poly
    from torus_fhe_tpu_torch.utils import noise, serialize

    params, parties, B = P.PARAMETER_REGISTRY[N3_SET](), 2, N3_TRIALS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "exact.key")
        poly.int8_matmul.calls = 0
        rep, counts, wall = launched(lambda: noise.measure_multikey(
            torch.Generator().manual_seed(SEED + 502), params, parties, trials=B,
            fast_form=False, cache_path=path, device=dev))
        products = poly.int8_matmul.calls
        size = os.path.getsize(path)
        ck = serialize.load_mk_cloud_key(path, device=dev)
    if any(counts.values()):
        raise AssertionError(f"N3: the exact route launched a kernel: {counts}")
    if not ck.exact or ck.bk_fb is not None:
        raise AssertionError("N3: the key file did not keep the exact form")
    check_report(f"N3 {N3_SET} exact", rep, N3_ENVELOPE)
    geom = keys3gen.mk_fb64_geometry(params, parties)
    tg = P.TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 64)
    args = (geom, tg.decomp_length, tg.log2_base, tg.offset)
    N = params.rlwe_polynomial_degree
    bara = torch.from_numpy(rng.integers(0, 2 * N, (B, geom.n)).astype(np.int32)).to(dev)
    acc = torch.from_numpy(rand_torus(rng, (B, 2, N), 64)).to(dev)
    c_tot, c_enq, busy_ms, top, host_s = scan_split(ck.bk_fb_sel, bara, acc, args)
    (rows, K, cols, nl), bound_ms = scan_shapes(B, geom, tg.log2_base)
    gate_step_ms = rep.bootstrap_wall_s / geom.n * 1e3
    device_step_ms = None if busy_ms is None else busy_ms / 64
    routes[f"{N3_SET} exact"] = {
        "route": "torch ops (fblock.blind_rotate_streamed, 64-bit, raw samples' lines)", **counts,
        "int8_matmul": products, "trials": B, "wall_s": wall, "gate_s": rep.bootstrap_wall_s,
        "gate_step_ms": gate_step_ms, "chunk_step_ms": c_tot / 64 * 1e3,
        "host_enqueue_step_ms": c_enq / 64 * 1e3, "host_step_ms_b1": host_s / 64 * 1e3,
        "device_step_ms": device_step_ms, "bound_ms": bound_ms, "key_file_bytes": size}
    log(f"N3 {N3_SET} exact", f"measure_multikey(fast_form=False) {wall:.2f} s with keygen and the "
        f"key file ({size / 1e6:.1f} MB); launches {counts}, int8 products {products}; the AND "
        f"B={B} {rep.bootstrap_wall_s:.3f} s = {gate_step_ms:.3f} ms a step over {geom.n} steps; "
        f"a 64-step chunk {c_tot / 64 * 1e3:.3f} ms a step (host enqueue {c_enq / 64 * 1e3:.3f}), "
        f"at B=1 {host_s / 64 * 1e3:.3f} ms a step (the host's share), kernels on the card "
        f"{'not measured' if device_step_ms is None else f'{device_step_ms:.3f} ms'} a step "
        f"(top: {'; '.join(top) if top else 'none'}); one int8 product ({rows} x {K}) @ ({K} x "
        f"{cols}) a step, {nl} limb blocks; bound from shapes {bound_ms:.1f} ms a rotate as "
        f"multiplied")
    del ck, bara, acc
    torch.cuda.empty_cache()
    return counts


def mk_knn_phase(dev, rng, routes) -> dict:
    """N6: apps/mk_knn.run_mk_pipeline at N6_KNN's set (compact key,
    blind_rotate_sel.cu), its own keygen, on a synthetic cardio-format CSV
    in a temporary directory: every prediction equals plaintext_oracle, and
    the threshold tail on the ring of parties x n decodes each prediction.
    Runs as a circuit phase: its launches, rows rotated, wall time and the
    kernels' share go into the ``circuits`` record (and so into the kernels'
    launches)."""
    import os
    import tempfile

    from torus_fhe_tpu_torch.apps import mk_knn
    from torus_fhe_tpu_torch.core import params as P

    name, parties, rows, tests, width, k = N6_KNN
    params = P.PARAMETER_REGISTRY[name]()
    header = ("id,age_days,age_year,gender,height,weight,ap_hi,ap_lo,cholesterol,gluc,smoke,"
              "alco,active,cardio")
    data = np.concatenate([np.arange(rows + tests)[:, None],
                           rng.integers(0, 4, (rows + tests, 5)),
                           rng.integers(0, 32, (rows + tests, 2)),  # ap_hi, ap_lo: the features
                           rng.integers(0, 4, (rows + tests, 5)),
                           rng.integers(0, 2, (rows + tests, 1))], axis=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cardio.csv")
        np.savetxt(path, data, fmt="%d", delimiter=",", header=header, comments="")
        res = circuit_phase(f"N6 run_mk_pipeline {name} (with keygen)", "blind_rotate_sel",
                            lambda: mk_knn.run_mk_pipeline(
                                torch.Generator().manual_seed(SEED + 503), params, parties, path,
                                k=k, width=width, train_rows=rows, test_rows=tests,
                                feature_cols=[6, 7], device=dev))
    expect(f"N6 {name} predictions", res["predictions"], res["oracle"])
    if not res["matches_oracle"] or len(res["predictions"]) != tests:
        raise AssertionError(f"N6: {res}")
    expect(f"N6 {name} threshold tail (ring {parties * params.lwe_size})",
           [[r["bit"] for r in t] for t in res["threshold_tail"]],
           [[p] * len(t) for p, t in zip(res["predictions"], res["threshold_tail"])])
    log(f"N6 {name}", f"{rows} train x {tests} test rows, width {width}, k={k}: predictions "
        f"{res['predictions']} == oracle {res['oracle']}, labels {res['labels']}; tails on ring "
        f"{parties * params.lwe_size}")
    torch.cuda.empty_cache()
    return {"blind_rotate": 0, "blind_rotate_sel": 0}  # counted in the circuits record


if __name__ == "__main__":
    sys.exit(main())
