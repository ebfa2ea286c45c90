"""Cost probes of the port on one NVIDIA H100, each run as
`python -m flash_attn_v100_tpu_torch.benchmarks.<name>`:

  prof_softmax_cost   P1: a flash step's stages (QK^T, max, exp2, sum, PV)
                      toggled one at a time;
  prof_fwd_gap        P2: a minimal flash forward plus one production
                      feature each (LSE, a pair-table grid, 4-D strides);
  prof_small_streams  P3: the minimal step plus int32 side streams, a trip
                      count read from device memory, a 3-way branch;
  prof_int4_native    P4: int4 x int4 on the tensor cores against int8 x
                      int4 unpacked to int8.

The counterparts of the JAX repository's TPU probes of the same names
(its benchmark folder), with the same variants and printed lines, on the
hand-written kernels of csrc/probes.cu and csrc/probe_int4.cu.  They
measure on the card and refuse to run without one.
"""
