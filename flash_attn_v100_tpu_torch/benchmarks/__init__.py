"""Cost probes and the hardware oracle suite of the port on one NVIDIA
H100, each run as `python -m flash_attn_v100_tpu_torch.benchmarks.<name>`:

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
hand-written kernels of csrc/probes.cu and csrc/probe_int4.cu.

  hw_oracle           the oracle suite: the four scripts below, then the
                      fuzz, each case gated against the fp32 oracle;
  sweep_dense         the reference's dense shape matrix, D 16-256, up to
                      8192^2, forward and backward, timed beside SDPA;
  sweep_varlen        mixed, equal, cross, window, softcap and ALiBi packed
                      batches, and the paged prefill;
  sweep_decode        a 32k paged decode with rotary and an append from
                      bf16, int8, int4 and fp8 pools, contiguous cases and
                      split-KV consistency, and the 32k decode's rate;
  verify_decode_fastpath  the decode's interior and boundary tiles;
  fuzz_oracle         random unaligned and ragged configurations, drawn as
                      the JAX repository's script draws them.

  bench_serving       the engine under a request mix: TTFT p50/p99 and
                      steady decode tokens/s;
  bench_decode        the decode's GB/s from bf16 and int8 pools across
                      contexts and split counts, against 3.35 TB/s;
  bench_lora_sft      LoRA fine-tuning: ms a step, tokens/s, the loss;
  dryrun_multiprocess the multi-host path as local processes: 2 x 4 ranks,
                      initialize(), a hybrid mesh, one sharded SGD step and
                      a sharded engine against a single-process one.

  profile_kernels     device time by kernel (port ids K1-K5) of the dense
                      prefill and its backward, the 32k decode from bf16
                      and int8 pools and a mixed varlen batch, against the
                      card's peaks, as markdown;
  prof_calibrate      the timer against a 2 GiB sum and a 4096^3 matmul:
                      no rate past 3.35 TB/s or 989 TFLOP/s;
  prof_decode_scan    the 32k decode chained 64 times, bf16 / int8 pools,
                      pages 256 / 512: time a call and device time;
  prof_decode_int8    the same variants unchained, best of rounds;
  prof_int4           int4 against int8 pools at the 32k decode;
  prof_decode_pagesize  the serving-shape decode at pages 128-1024;
  prof_int4_rmw       one-round against two-round int4 decode append;
  prof_decode_attrib  a decode step's device time against the engine's
                      ms a step at decode_fuse 1 / 8 / 16 / 32;
  prof_ttft_tail      TTFT p50 / p90 of a 24 x 2048-token burst by
                      scheduling knob set;
  bench_scaling       ring prefill and head-sharded decode over 1-16 gloo
                      ranks, efficiency T(1) / T(n);
  check_ring_overlap  a profiler trace of the ring: each chunk's K1 runs
                      while its K/V shift is in flight.

Each is the counterpart of the JAX repository's script of the same name.
They run on the card and refuse to run without one; the bench scripts and
the measurement scripts also take `--device cpu` (the kernels' plain
versions).
"""
