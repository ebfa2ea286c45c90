"""Examples of the port, each run as
`python -m flash_attn_v100_tpu_torch.examples.<name> [--device cpu]`:
attention_basics (the three attention entry points), serve_engine
(continuous batching from an int8 pool) and train_seq_parallel (ring
attention over spawned gloo ranks).  They run on the GPU unless given
`--device cpu`, where the kernels' plain versions stand in."""
