#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--src DIR]

Builds the port's CUDA kernels from the sources in this checkout, then
drives the port's routes — ``CEAZ.compress`` -> ``CEAZ.decompress`` —
through the public facade, at rel eb 1e-4 unless said otherwise:

  phase A  CESM-like 2-D field, 1800x3600 f32 (25.9 MB, the size of the
           paper's CESM-ATM fields), default 32 MB chunks (one chunk),
           exact codebooks: dq2d, gather-pack, word-tiled walk kernels;
  phase B  HACC-like 1-D field, 2^23 f32 (32 MB), chunk_bytes=2^19 (64
           chunks of 2^17 values), exact codebooks: dq1d, gather-pack,
           decode-megakernel kernels, the Lorenzo chain carried across
           all 64 rows;
  phase C  the HACC field with the default codebook bank, 64 chunks of
           2^17 (the one-program regime of the bank encode): one Lorenzo
           quantize+histogram+select launch, gather-pack; decode
           megakernel;
  C.value  the NWChem-like field below, value-direct with the bank at
           rel eb 1e-3 in the same 64 chunks of 2^17: the value
           quantize and the finalize+select launch (counted as the
           one-program kernel), dq_center, pack; decode megakernel
           adding each chunk's centre;
  phase D  the HACC field with the bank at the default 32 MB chunk (one
           2^23-value chunk, the tiled regime): the same kernels counted
           as the tiled ones; word-tiled walk;
  phase E  NWChem-like 1-D field, 2^23 f32, value-direct prediction
           (predictor='none') at rel eb 1e-3 and the default chunk,
           twice: with the bank
           (value quantize, dq_center median, value finalize+histogram
           +select, pack) and with exact codebooks (the same three
           pass-1 kernels, then the exact route's pack); decode adds
           each chunk's centre;
  E.drift  the same field with the bank at rel eb 1e-4, where over half
           its values escape: the bank pass runs, the host replay's
           drift passes the facade's tolerance and the whole array is
           re-encoded on the exact route (the fallback counter must
           rise by one, every chunk must leave the bank);
  phase F  the CESM field with the bank: dq2d, bank select, gather-pack,
           word-tiled walk;
  phase G  the HACC field in fixed-ratio mode (target ratio 10,
           chunk_bytes=2^19: 64 chunks of 2^17, speculation 'auto'),
           exact codebooks: each speculation window quantized by one
           Lorenzo quantize+histogram launch (the one-program kernel),
           gather-pack, decode megakernel with each chunk its own chain;
           the achieved ratio must be within 15% of the target and every
           value within its chunk's bound;
  G.off    the same with speculation 'off' (the sequential loop: dq1d per
           chunk); its stream must equal phase G's;
  G.bank   phase G with the codebook bank: each window one bank-encode
           op (the quantize+select launch, the pack), no second pass;
  phase S  the streams of phases A, B, E.exact and G decoded again with
           decode_megakernel='split' (S.A, S.B, S.E, S.G): the split
           route's walk kernel (hufdec), then the outlier scatter and the
           inverse as torch ops; neither decode megakernel kernel may
           launch, and the bytes must equal the megakernel route's;
  phase T  the staged route (``use_fused=False``, backend 'torch'): T.A the
           CESM field as phase A (one 32 MB chunk: dq2d, the histogram
           kernel, the large-chunk packer), T.E the NWChem field
           value-direct at rel 1e-3 (the value kernels, dq_center,
           histogram, the large-chunk packer), T.G the HACC field's first
           2^21 values at fixed ratio 10 in 64 chunks of 2^15
           (chunk_bytes=2^17, the reference's section 4.7 settings: dq1d,
           histogram and the gather-pack per chunk, 8 tiles on 8 CTAs;
           the whole field's 256 chunks until phase SERVE.SSM came, cut
           for the run's time). Staged decode is
           the host table decode. T.A's stream must equal phase A's, T.E's phase E.exact's
           and T.G's the fused route's at the same settings;
  BATCH    the HACC field as 4 shards of 2^21 through ``compress_batch``:
           fused (one pass pair: dq1d per shard, one histogram and one
           pack launch; one batched decode, the tiled walk) and, as
           BATCH.staged, with use_fused=False (per
           shard: dq1d, histogram, the packer encode_device's rule
           picks: the large-chunk packer); every shard
           must equal its own ``compress`` and both batches each other;
  phase P  the paper's MPI_Gather scenario, fixed width: 4 ranks, each a
           Nyx-like 256^3 f32 field (64 MB, seeded per rank), through
           ``io.collectives.compressed_all_gather`` with no group (the
           rank axis leading, one card) at 8 and 4 bits, without and with
           the Lorenzo residual stream (P.b8, P.b8.lorenzo, P.b4,
           P.b4.lorenzo): the bitpack pack and unpack kernels;
  phase Q  the gradient exchange: the weight and norm leaves of 2 of
           gemma3-1b's 26 layers at its published widths (d_model 1152,
           4 q heads and 1 kv head of 256, d_ff 6912; 26.8 M values a
           layer) on 4 pods (215 M values), gradients from --seed; 3 steps
           of error feedback + ``compressed_cross_pod_mean`` at 8 bits,
           then ``adamw_update`` on the pod mean: pack and unpack a leaf;
  Q.snap   ``snapshot_grads`` then ``restore_grad_snapshot`` on five of
           the last step's pod-mean leaves, through the facade;
  phase W  the paper's MPI_File_write: phase P's 4 Nyx ranks through
           ``io.filewrite.parallel_compressed_write`` (the default facade
           on the card, overlapped, fsync) into one ``.ceazs`` stream in a
           temporary directory under ``build/``, read back by
           ``parallel_read`` (self-configured): every payload equals the
           facade's compress of its rank on the card, the read bytes its
           decompress (rank 0's also on the CPU);
           ``overlap=False`` gives the same records, and ``write_stream``
           with telemetry off the same file sync and async (rank-3
           Lorenzo runs as the torch twin; histogram, pack, tiled walk);
  W.staged the HACC field as 4 shards of 2^21 through the dump with
           ``use_fused=False``: payloads equal the fused route's;
  W.bank   the same shards through ``write_stream`` with the codebook bank:
           the footer carries the bank, the default reader resolves it and
           every chunk stays on the bank route;
  W.fuzz   tests/test_engine.py's fuzz stream written on the card; every
           stream-level case of tests/corpus/decode_fuzz_corpus.json
           (replayed by tests/corpus/stream_cases.py) must be judged
           corrupt by the card's mega, split and staged decode routes, and
           the pristine stream decode to the same bytes on all three. W,
           W.staged and W.bank print write and read GB/s of raw input (the
           whole write call, footer, fsync and rename included, and the
           whole read call, each on the host clock after a device sync)
           beside the card, and the engine's wall, compress, serialize and
           write seconds, overlap efficiency and ratio;
  phase R  the paper's MPI_Gather through the Huffman codec: P's 4 Nyx
           ranks through ``io.collectives.ceaz_gather`` at the reference's
           defaults (rel 1e-4, 2^20-value chunks, block 4096): ONE batched
           pass pair (the ``ceaz.batch_fused_pass`` span opens once, n=4),
           each rank's stream equal to the card's single compress, rank
           0's to the CPU facade's; ``ceaz_gather_decode`` gives rank 0
           the CPU's bytes, every rank within the bound; a ragged set
           (the last rank 256x256x200)
           batches 3 and passes the last alone; ``ceaz_gather_stream``
           overlapped and sync give the same records, and
           ``read_gather_stream`` the decode's bytes;
  Q.stream Q's pod-mean gradient tree (53.7 M values) through
           ``snapshot_grads_to_stream`` and ``restore_grad_snapshot_stream``
           on the card: SNAP_LEAVES' records and bytes equal the CPU
           run's, lossy leaves within 1e-3 x range, raw leaves bit-exact;
  phase K  Q's parameter tree (214.7 MB f32) and a second one through
           ``checkpoint.ckpt.save_checkpoint`` (step 1 synchronous, step 2
           in the background) and ``restore_checkpoint`` (plan=None: host
           arrays within 5e-4 x range, raw leaves bit-exact; a one-device
           mesh on cuda:0 with a bf16 ``leaf_transform``: the bf16 cast
           there); ``mode='raw'`` bit-exact; layer 0's records equal a
           device='cpu' save's; after V, bytes flipped in step 2's stream
           make the restore fall back to step 1;
  phase V  a ``serve.PagedParamStore`` over K's step-1 stream (bf16, a
           budget of one layer's decoded bytes): 64 seeded gets, each leaf
           the full restore's bf16 cast bit for bit, resident bytes within
           the budget after every get, counters and gauge consistent; a
           swap to step 2 while a pin on the first generation is held: the
           pin reads step 1, new pins step 2. R, Q.stream, K and V print
           host-clock seconds and GB/s of raw input of their whole calls
           (V: page-in and cache-hit ms) beside the card, and each phase's
           seconds;
  SERVE    the serving path at gemma3-1b's published widths (26 layers,
           22 with a 512 window; 999,885,952 parameters from --seed on
           the card, f32): ``save_checkpoint`` at its defaults, then
           ``launch.serve.restore_serving_params`` in full (bf16; every
           lossy leaf within eb range(x) + half a bf16 ulp of the saved
           one, raw leaves the bf16 cast) and paged (unit 0, embed/table
           and every leaf bitwise the full restore's; one decode step
           from the paged tree the same logits bits); 4 requests at B = 4
           of 264 seeded prompt tokens teacher-forced through
           ``make_decode_fn``'s step and 8 greedy tokens (logits finite,
           pos 272; 600 + 32 until phase SERVE.SSM came, cut for the
           run's time), ``make_prefill_fn`` on the prompts. The
           restored weights cut to the first unit's first repeat (5 local
           layers, 1 global) hold the bound the CPU parity tests state
           (rtol 0.06, atol 0.05) with the compute dtype f32: prefill
           against the 520-token teacher-forced decode on the card (the
           512-slot rings wrap), and a
           64-token prompt with 4 greedy steps at B = 2 on the card
           against the port on the CPU. The bf16 path that serves reads
           over that bound (bf16 rounds in other places on each side), so
           its two readings are held to limits set from sound runs
           (BF16_LIMITS, ratios to the bound): the 26-layer prefill
           against its teacher-forced decode, and the cut's bf16 run on
           the card against the port's bf16 run on the CPU. Each limit
           has a control that must read past it: the same comparison with
           the KV cache rounded through float8 e4m3.
           Prints the save, restore and paging times, prefill ms, decode
           ms a step and tokens/s, device memory allocated before and at
           the peak of the restore and of the requests, and the phase's
           seconds beside the card.
  SERVE.MOE the MoE and MLA archs at their published widths, depth cut:
           phi3.5-moe's first layer (32 q and 8 kv heads of 128, 16
           experts of d_ff 6400 top 2, vocab 32064; 1,431,646,208
           parameters) saved and restored in full as SERVE does (leaves
           within their bound, every tiled walk bitwise against its plain
           version), and deepseek-v2's dense first layer and first MoE
           layer (MLA of 128 heads, kv_lora 512; 160 experts of 1536 top 6,
           2 shared; vocab 102400; 4,834,391,040 parameters) drawn on the
           card and cast to bf16 (no save: ~2 min at the codec's rate).
           Each serves in bf16 a prefill of 2 x 256 tokens (its routed
           pairs dropped over capacity counted), the prompt teacher-forced
           and 8 greedy steps (logits finite, pos 264). Then each is held
           layer by layer against the port on the CPU (one layer's weights
           on the host at a time; MemAvailable before each layer and the
           peak RSS printed, and a layer whose weights do not fit the
           host's MemAvailable fails the phase): with the
           compute dtype f32, each prefill layer's output, each layer's
           decode cache slots (c_kv and k_rope, or k and v) and the
           logits within the bound, each MoE layer's routing on the CPU
           given the card's gates bitwise (top-k ids and weights, order,
           counts, slots, drop mask), and the tokens the CPU's own gates
           route otherwise counted (the same in bf16, printed with no
           limit, until phase TRAIN came, cut for the run's time). Each arch
           is a counted run of its own (SERVE.MOE.<arch>);
  SERVE.ZOO gemma3-4b, gemma-7b, glm4-9b, qwen2-vl-7b and whisper-base at
           their published widths, depth cut to the first layer
           (gemma3-4b's first repeat of 6 until phase TRAIN came, cut for
           the run's time; the other four have one layer a repeat), each
           with its full vocabulary and embedding (gemma-7b's
           786 M-value table the largest the codec decodes here): saved,
           restored in full as bf16 (seconds and peak allocated), every
           leaf within its bound and every tiled walk bitwise, then a
           prefill of 2 x 64 tokens, the prompt teacher-forced and 4
           greedy steps with finite logits (counted runs
           SERVE.ZOO.<arch>);
  SERVE.SSM the SSM archs at their published widths: rwkv6-1.6b's
           first 4 of its 24 layers (d 2048, d_ff 7168, vocab 65536;
           356,100,096 parameters; all 24 until phase TRAIN came, cut for
           the run's time) saved, restored in full as bf16 and served, and
           zamba2-7b's first unit's first repeat (the shared attention
           block, 6 mamba2 layers of 112 heads, state 64, the embedding;
           788,088,032 parameters; its restore launches the decode
           megakernel) saved and restored, then the whole
           zamba2 (81 mamba2 layers in units of 13 x 7 and 1 x 4 with
           the shared block; 6,636,442,832 parameters) drawn on the card
           as bf16 and served: a prefill of 2 x 80 tokens, zamba2's whole
           model 2 x 32 (both 256 until phase TRAIN came, cut for the
           run's time), the prompt teacher-forced and 8 greedy steps
           (logits finite),
           every restored leaf within its bound and every decode call of
           the restores bitwise. Then rwkv6's first 2 layers and the
           first two blocks of zamba2's restored cut (4 layers and the
           whole cut until phase TRAIN came) are held layer by layer
           against the port on the
           CPU as SERVE.MOE's are (2 x 80 tokens and 2 steps; an SSM
           layer's conv, state, sx and sx_cmix after the prompt against
           the CPU's own teacher-forced decode of the layer's recorded
           inputs), f32 to the bound. Prints the save and
           restore seconds, GB/s and peaks, prefill ms, decode ms a step,
           tokens/s and the decode cache's bytes a sequence beside a
           bf16 K and V cache's (counted runs SERVE.SSM.<arch>). Row 4
           gets a timed case at each walk shape these three phases add.
  TRAIN    the training path: gemma3-1b at its published widths, its
           first repeat (6 of 26 layers, 463,043,712 parameters; the
           whole model until TRAIN.DIST came, cut for the run's time;
           f32, bf16 AdamW moments) drawn
           by ``launch.train``'s init_state on the card and trained by
           ``launch.train.main`` for 6 steps of ``batch_for_step`` data
           at B = 2, S = 2048 (bf16 compute, remat 'block', the flash
           backward, ``chunked_xent``), the whole state checkpointed
           compressed at steps 3 and 6; step 3's checkpoint alone resumed
           by ``main --resume`` (restored on the card) for steps 4-6
           again, which checkpoint step 6 once more:
           losses finite, step 0's within (0.5 ln V, 3 ln V), grad norms
           finite and > 0, the resumed batches bitwise, the restored
           state within the checkpoint's rel 5e-4 (raw leaves bitwise)
           and some of its leaves bitwise the CPU's decode, every restore
           walk bitwise; the first repeat's loss and gradients on the card
           against the CPU in f32, and the flash backward at the model's
           attention shapes against the CPU and a naive f32 attention,
           to one bf16 rounding (2^-7 relative L2). Prints step ms, a
           profiled step's device ms and idle share, tokens/s, the peak
           allocated with remat 'block' and 'none', the save and restore
           seconds, GB/s and ratio (counted run TRAIN; its codec calls
           held at first sight as the SERVE.* phases' are).
  TRAIN.DIST  (run first, right after the build, while the card holds
           nothing of the other phases) training over several processes:
           each rank a process of a gloo world on the one card
           (``runtime/dist.py::launch``; the exchanges staged through the
           host), gemma3-1b's first repeat (6 of 26 layers, 463,043,712
           parameters) at its published widths and full vocabulary. A
           world of 4: (a) (data=2, model=2), global batch 4 x 1024, 3
           steps in f32 compute: losses within 5e-2 of the parent's
           one-process run, step 0's whole gradients within 2^-7 of its
           and alike on every rank, every rank's shards after init bitwise the slices of
           its leaves; (b) (pod=2, data=1, model=2) without and with the
           8-bit compressed exchange inside the step: every loss and
           every rank's shards after every step bitwise the parent's
           one-process emulation on a logical mesh, the compressed losses
           within 0.05 of the uncompressed, the bitpack pair launched in
           the step; (c) the uncompressed run's state saved compressed
           from the 4 ranks; (d) the GPipe pipeline over 4 stages of one block, 6
           microbatches of (1, 512, 1152) f32, bitwise the parent's
           sequential_reference. A world of 2: (c) that checkpoint
           restored onto (data=1, model=2), every rank's shards bitwise
           the slices of the parent's one-process restore; (e)
           phi3.5-moe's MoE block at its published widths expert-parallel
           over model=2 (8 experts a rank), 2 x 256 bf16 tokens: output,
           routing, capacity and drops bitwise the parent's one-process
           ``moe_block_by_shards``. The children's launch counts (each
           child's counts set to 0 before its work, read after) join the
           kernels line; their codec calls are not held at first sight
           (the save's and restore's shapes are TRAIN's). Prints step ms,
           the gloo staging's, the gloo exchange's and the compressed
           exchange's shares of a step, each rank's peak, the save and
           restore seconds.
  SERVE.DIST  serving over the ranks of TRAIN.DIST's two worlds, after
           their training work (no CUDA init of its own), gemma3-1b's
           first repeat in bf16: the world of 2 restores the (c)
           checkpoint for serving on (data=1, model=2), in full and paged
           (every rank's shards bitwise the slices of the parent's bf16
           restore, the paged leaves bitwise the full ones, the tiled
           walk launched by both), then serves B 2 x 252 prompt tokens
           and 8 greedy steps into 512-slot caches through the paged
           store's collective pins; the world of 4 serves weights drawn
           from the seed on (data=2, model=2), B 4 (2 rows a rank) and B
           1 under decode_wide, 60 + 8 tokens into 128 slots. The
           prompt's cache is ingested by a one-process decode over the
           weights gathered once and placed by ``place_cache``; prefill
           and decode are the rank-aware callables. Every prefill and
           step logit, the placed and final cache slices of every rank
           bitwise the parent's one-process run over the same rows on
           the card, decode writing into exactly the slices that hold
           its positions; B 4 also within the bound of the parent's
           whole batch. Prints prefill ms, decode ms a step, its gloo
           and staging seconds and bytes, the restore and paged
           seconds and each rank's peak (counted with the children's
           launches as SERVE.DIST).

Each phase is run with the kernels' launch counts set to 0 just before
and read just after, and must launch every kernel of its path. Phases P
and Q hold their packed words, scales, pod means and residuals bitwise
against the port's CPU run; decoded values and AdamW states to the
bounds derived in ``io/collectives.py`` (``step_bound``,
``lorenzo_bounds``) and ``optim/adamw.py`` (``norm_error``,
``step_deviation``). A count
is one per launch: a quantize launch counts under the TPU kernel whose
work it does at that row length (``ceaz_chunk_fused`` up to 2^17
values, the tiled kernel past it). Its
stream (every CompressedChunk field, the literals) and decoded bytes
must equal the port's own CPU run of the same input bit for bit, and
the reconstruction must hold the error bound. The bank encode op
launches no separate select on the phases that run it alone
(NO_SELECT_PHASES). Every kernel is then
called on the inputs the main path gave it and held BITWISE against its
plain PyTorch version on the card (integer outputs: tolerance 0), and
timed (CUDA events around one call, median after warm-up: warm, and at
small shapes mostly the wrapper's host time). Every kernel also gets
its device time, L2-cold: everything one call puts on the device —
kernels, torch glue, the zeroing of its outputs (``cold_device_ms``:
torch.profiler's record, a 256 MB buffer written before every call) —
beside its bound, its wrapper's host time and an empty launch through
the same binding (the floor). The pass-2 pack (``gather_pack_tiled``),
the bank encode op (row 9), ``dq_center`` (row 13) and the staged
route's large-chunk packer (row 7, ``hufenc``) are held and timed at
every shape where the counted runs called them, from censuses of their
calls printed before the kernels line (``dq_center`` by phase too, with
each row's valid-key range, and beside two torch.kthvalue calls at
E.bank); a row-7 call must put one kernel and one memset on the device.
The
three warp walks (``hufdec_tiles``, the split route's ``hufdec``, the
decode megakernel) are held and timed at every phase where they launch
and on garbage and bit-flipped streams (``hufdec_tiles`` at every call
of SERVE's restores, timed once a shape); SERVE's value-direct
quantize and finalize (rows 11-12), Lorenzo quantize (row 2) and
histogram (row 14) are held and timed as cases of their rows at the
calls SERVE gave them. The serving phases after SERVE keep no kernel
arguments (their groups are GBs): every call there whose key is new to
the phase (rows 1-3, 9 and 11-14; the tiled walks are all kept and held)
is held bitwise against its plain version as it returns, in slices of
rows, and each kernel such a phase launches must have been launched by
a call so held; the holds' seconds are left out of the saves' seconds.
A device time is read only from profiled calls recorded whole, and is
null with its reason where none can be had at or above the bound; after
each decode phase the
script prints their counters (blocks kept from the fast path, blocks
walked by the serial walk, most sync rounds); no block of a valid
stream may take the serial walk, and some of each walk's garbage blocks
must. The script prints the card
(nvidia-smi name and power limit), the build time, per-kernel results,
compress/decompress throughput, the W phases' stream figures, the
consumer phases' figures, SERVE's figures (also in the throughput JSON
line), one JSON line of kernels and, last,
``{"ok": true, "device": {...}}``. Any failed check raises: the exit
code is then non-zero and the last line is not printed.

``--src DIR`` imports ``repro_torch`` from DIR instead of this
checkout's ``src`` and changes nothing else: the same phases, checks and
timed cases run against another commit's package (unpacked by ``git
archive`` into a directory that ``.gitignore`` lists, e.g.
``build/parent``; its kernels build into that tree's own ``build/``),
so parent and change are measured by one instrument in one chip call.
"""
import concurrent.futures
import contextlib
import json
import resource
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
NUM_SYMBOLS = 1024
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
REPLACES = {
    "dq1d": "src/repro/kernels/dualquant/kernel.py:101",
    "dq2d": "src/repro/kernels/dualquant/kernel.py:131",
    "gather_pack_tiled": "src/repro/kernels/hufenc/kernel.py:267",
    "hufdec_tiles": "src/repro/kernels/megakernel/decode_kernel.py:246",
    "ceaz_chunk_dec_fused":
        "src/repro/kernels/megakernel/decode_kernel.py:146",
    "ceaz_chunk_fused": "src/repro/kernels/megakernel/kernel.py:138",
    "lorenzo_tiles": "src/repro/kernels/megakernel/kernel.py:254",
    "value_quant_tiles": "src/repro/kernels/megakernel/kernel.py:290",
    "value_finalize_tiles": "src/repro/kernels/megakernel/kernel.py:306",
    "dq_center": "src/repro/kernels/dualquant/kernel.py:220",
    # the select stage of ceaz_chunk_fused (its tiled regime runs it as
    # jnp, megakernel/ref.py::select_bank)
    "bank_select": "src/repro/kernels/megakernel/kernel.py:111",
    "hufdec": "src/repro/kernels/hufdec/kernel.py:85",
    "pack": "src/repro/kernels/bitpack/kernel.py:46",
    "unpack": "src/repro/kernels/bitpack/kernel.py:65",
    "histogram": "src/repro/kernels/histogram/kernel.py:39",
    "gather_pack": "src/repro/kernels/hufenc/kernel.py:164",
    # with the reference's host hufenc/ops.py::to_host_stream
    "hufenc": "src/repro/kernels/hufenc/kernel.py:344",
}
SOURCES = {
    "dq1d": "src/repro_torch/csrc/dualquant.cu",
    "dq2d": "src/repro_torch/csrc/dualquant.cu",
    "gather_pack_tiled": "src/repro_torch/csrc/hufenc.cu",
    "hufdec_tiles": "src/repro_torch/csrc/hufdec.cu",
    "ceaz_chunk_dec_fused": "src/repro_torch/csrc/decode_fused.cu",
    "ceaz_chunk_fused": "src/repro_torch/csrc/bank.cu",
    "lorenzo_tiles": "src/repro_torch/csrc/bank.cu",
    "value_quant_tiles": "src/repro_torch/csrc/bank.cu",
    "value_finalize_tiles": "src/repro_torch/csrc/bank.cu",
    "dq_center": "src/repro_torch/csrc/center.cu",
    "bank_select": "src/repro_torch/csrc/bank.cu",
    "hufdec": "src/repro_torch/csrc/hufdec.cu",
    "pack": "src/repro_torch/csrc/bitpack.cu",
    "unpack": "src/repro_torch/csrc/bitpack.cu",
    "histogram": "src/repro_torch/csrc/histogram.cu",
    "gather_pack": "src/repro_torch/csrc/hufenc.cu",
    "hufenc": "src/repro_torch/csrc/hufenc.cu",
}
_VALUE = ("value_quant_tiles", "dq_center", "value_finalize_tiles")
_BLOCKS = ("histogram", "hufenc")
PHASE_KERNELS = {
    "A": ("dq2d", "histogram", "gather_pack_tiled", "hufdec_tiles"),
    "B": ("dq1d", "histogram", "gather_pack_tiled", "ceaz_chunk_dec_fused"),
    "C": ("ceaz_chunk_fused", "gather_pack_tiled", "ceaz_chunk_dec_fused"),
    "C.value": ("ceaz_chunk_fused", "dq_center", "gather_pack_tiled",
                "ceaz_chunk_dec_fused"),
    "D": ("lorenzo_tiles", "gather_pack_tiled", "hufdec_tiles"),
    "E.bank": _VALUE + ("gather_pack_tiled", "hufdec_tiles"),
    "E.exact": _VALUE + ("gather_pack_tiled", "hufdec_tiles"),
    "E.drift": _VALUE + ("gather_pack_tiled", "hufdec_tiles"),
    "F": ("dq2d", "histogram", "bank_select", "gather_pack_tiled",
          "hufdec_tiles"),
    "G": ("ceaz_chunk_fused", "gather_pack_tiled", "ceaz_chunk_dec_fused"),
    "G.off": ("dq1d", "histogram", "gather_pack_tiled",
              "ceaz_chunk_dec_fused"),
    "G.bank": ("ceaz_chunk_fused", "gather_pack_tiled",
               "ceaz_chunk_dec_fused"),
    "T.A": ("dq2d",) + _BLOCKS,
    "T.E": _VALUE + _BLOCKS,
    "T.G": ("dq1d", "histogram", "gather_pack"),
    "BATCH": ("dq1d", "histogram", "gather_pack_tiled", "hufdec_tiles"),
    # + the packer the imported package's rule picks (staged_packers)
    "BATCH.staged": ("dq1d", "histogram"),
    # the stream phases (rank-3 Lorenzo has no kernel in the reference:
    # W's pass 1 is the torch twin on the card)
    "W": ("histogram", "gather_pack_tiled", "hufdec_tiles"),
    "W.staged": ("dq1d", "histogram", "hufdec_tiles"),
    "W.bank": ("lorenzo_tiles", "gather_pack_tiled", "hufdec_tiles"),
    "W.fuzz": ("dq1d", "histogram", "gather_pack_tiled",
               "ceaz_chunk_dec_fused", "hufdec"),
    # the consumers: R (rank-3 Lorenzo: the torch twin, as W); Q.stream,
    # K and V choose their predictor per leaf and their decode walk by
    # chunk length, so their walks are checked apart
    # (check_decoded_on_card)
    "R": ("histogram", "gather_pack_tiled", "hufdec_tiles"),
    "Q.stream": ("gather_pack_tiled",),
    "K": ("gather_pack_tiled",),
    "V": (),
    # the serving path: its save encodes each leaf as K's does, its full
    # and paged restores decode (the walk by chunk length)
    "SERVE": ("gather_pack_tiled",),
    # the MoE and MLA archs: phi3.5's save and restore as SERVE's;
    # deepseek's cut is drawn on the card and served without the codec
    "SERVE.MOE.phi3.5-moe-42b-a6.6b": ("gather_pack_tiled",),
    "SERVE.MOE.deepseek-v2-236b": (),
    # the other attention archs' full-vocabulary saves and restores
    **{f"SERVE.ZOO.{a}": ("gather_pack_tiled",) for a in (
        "gemma3-4b", "gemma-7b", "glm4-9b", "qwen2-vl-7b", "whisper-base")},
    # the SSM archs: rwkv6's first 4 layers and zamba2's first repeat
    # saved and restored (zamba2's restore must also launch the decode
    # megakernel: SSM_ALSO); zamba2's whole model is drawn on the card
    **{f"SERVE.SSM.{a}": ("gather_pack_tiled",) for a in (
        "rwkv6-1.6b", "zamba2-7b")},
    # training: the checkpoints of the whole state encode as K's do; the
    # resume decodes (the walk by chunk length)
    "TRAIN": ("gather_pack_tiled",),
}
# the serving phases after SERVE and the training phase keep no kernel
# arguments (a kept (C, 2^20) group is GBs, and five archs' groups would
# not fit beside them on the card): each call there is held bitwise
# against its plain version when its (phase, wrapper, key) is first seen
# (Sight), in row slices of at most SIGHT_VALUES values, and its
# arguments dropped
SIGHT_PHASES = tuple(p for p in PHASE_KERNELS
                     if p.startswith(("SERVE.", "TRAIN")))
SIGHT_VALUES = 1 << 26
# dispatch ops held at first sight beside the censuses' wrappers (rows
# 3, 9 and 13 are held in theirs): op -> the indices of its arguments
# sliced by rows, or None (held whole). The tiled decode walks are all
# kept and held after the run (hold_kept_decodes)
SIGHT_OPS = {"dualquant": None, "histogram": (0, 1),
             "value_quant": (0, 1), "value_finalize": (0, 1, 2),
             "lorenzo_quant": (0, 1, 2, 3), "bank_select": (0,)}
# the staged phases' fused counterparts at the same settings: the
# streams must be identical (T.G's counterpart is run there)
STAGED_TWINS = {"T.A": "A", "T.E": "E.exact"}
# phases whose staged host decode (64 chunks of 2^15 through the table
# walk of core/huffman.py) takes seconds: timed once, on the counted
# run, and left out of the traced round trip
ONE_DECODE_PHASES = ("T.G",)
# the split decodes: stream of phase -> its S phase; the walk kernel must
# launch and neither decode megakernel kernel may
SPLIT_PHASES = {"A": "S.A", "B": "S.B", "E.exact": "S.E", "G": "S.G"}
SPLIT_FORBIDDEN = ("ceaz_chunk_dec_fused", "hufdec_tiles")
FIXED_RATIO_ENVELOPE = 0.15      # the reference's tests/test_full_grid.py
# phases whose bank pass must fall back to the exact route
DRIFT_PHASES = ("E.drift",)
# the bank encode op folds its select into its quantize launch: no phase
# that runs the op alone may launch the standalone select
NO_SELECT_PHASES = ("C", "C.value", "D", "E.bank", "E.drift", "G.bank")
CAPTURED_OPS = ("dualquant", "hufenc", "ceaz_chunk_dec", "ceaz_chunk",
                "value_quant", "dq_center", "value_finalize", "bank_select",
                "lorenzo_quant", "hufdec", "histogram", "gather_pack",
                "hufenc_flat", "hufenc_blocks")
# calls a counted run keeps beside each op's first, under "<op>.kept":
# {op: keep(args)}. Phase SERVE sets it for every decode call that takes
# the tiled walk and for the first value-direct calls of 2^20-value chunks
KEEP_CALLS = {}
# the staged route's large-chunk packer (row 7): the op of the imported
# tree, `hufenc_flat`, or a parent's per-block packer `hufenc_blocks`
# (then with its stitch); ops a tree does not register are not captured
ROW7_OPS = ("hufenc_flat", "hufenc_blocks")
# the wire path's ops: the call with the most values is kept
WIRE_OPS = ("pack_words", "unpack_words")


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5, warmup=2):
    """Median wall time on the card of fn(), by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


L2_FLUSH_BYTES = 256 << 20       # 5x the H100's 50 MB L2


def _device_events(prof):
    """The device-side events (kernels, memsets, copies) of a profile, in
    start order."""
    ev = [e for e in prof.events()
          if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sorted(ev, key=lambda e: e.time_range.start)


def profiled_calls(fn, reps=10):
    """The device events (name, us) of each of `reps` calls of fn with a
    cold L2: everything the call put on the device — its kernels, its
    torch glue, the zeroing of its outputs — from torch.profiler's record
    of the calls, each after a 256 MB buffer is written, so that every
    call reads its inputs from device memory and not from the L2 the
    last call left them in. A marker kernel (torch.cuda._sleep's
    spin_kernel, which no op launches) follows each flush: a call is the
    events after a marker, less the next call's flush."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.add_(1)
            torch.cuda._sleep(1)
            fn()
        torch.cuda.synchronize()
    calls = []
    for e in _device_events(prof):
        if "spin_kernel" in e.name:
            if calls and calls[-1]:
                calls[-1].pop()          # this call's flush
            calls.append([])
        elif calls:
            calls[-1].append((e.name, e.time_range.elapsed_us()))
    del flush
    return [c for c in calls if c]


PROFILE_SESSIONS = 3
# (what, why) of each device time read as null (cold_device_ms)
PROFILE_FAULTS = []


def _torch_event(name):
    """A device event of torch's own (its kernels and cub's, memsets,
    copies), not one of the port's kernels."""
    return (name.lower().startswith(("memset", "memcpy")) or "at::" in name
            or "at_cuda_detail" in name or "cub::" in name)


def cold_device_ms(fn, reps=10, bound_ms=None, what="a call"):
    """Device ms of one call of fn with a cold L2 (profiled_calls): the
    median over the calls a profiler session recorded whole. A session
    now and then records a call only in part (seen on the card), so a
    call whose device events are not those of the session's fullest call
    is dropped, and the session is taken again, up to PROFILE_SESSIONS,
    where under half its calls are whole, where its fullest call holds
    fewer of the port's kernels than one call of fn counts launches, or
    where its median is under `bound_ms` (a time no call can take).
    Then None, its reason printed and kept in PROFILE_FAULTS."""
    from repro_torch.kernels import dispatch
    before = sum(dispatch.launches().values())
    fn()
    launched = sum(dispatch.launches().values()) - before
    why = "no session recorded a call"
    for _ in range(PROFILE_SESSIONS):
        calls = profiled_calls(fn, reps)
        if not calls:
            continue
        names = [n for n, _ in max(calls, key=len)]
        whole = [c for c in calls if [n for n, _ in c] == names]
        mine = sum(not _torch_event(n) for n in names)
        ms = statistics.median(sum(us for _, us in c) for c in whole) / 1e3
        if 2 * len(whole) < reps:
            why = f"{len(whole)} of {reps} calls recorded whole"
        elif mine < launched:
            why = (f"{mine} of the port's kernels in the fullest call, "
                   f"{launched} launches counted a call")
        elif bound_ms is not None and ms < bound_ms:
            why = f"{ms} ms, under the bound {bound_ms} ms"
        else:
            return ms
    PROFILE_FAULTS.append((what, why))
    print(f"device time of {what}: null after {PROFILE_SESSIONS} profiler "
          f"sessions ({why})")
    return None


def host_call_ms(fn, reps=100):
    """Host ms of one call of fn: the mean over `reps` calls issued back
    to back with no sync between them (the card keeps up at the shapes
    timed), so the wrapper's host side alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def pct_of_bound(bound_ms, device_ms):
    """The bound's share of a cold device time, in percent."""
    return None if not device_ms else 100 * bound_ms / device_ms


def host_s(fn, reps=3):
    """Median host seconds of fn() ending in a device sync."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def same_outputs(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and bool((x == y).all())
        for x, y in zip(a, b))


def same_bits_or_nan(a, b):
    """Float tensors equal bit for bit where not NaN, and NaN at the same
    places: the card makes the canonical NaN where x86 propagates an
    operand's payload."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(na, nb)
            and torch.equal(a[~na].view(torch.int32),
                            b[~nb].view(torch.int32)))


def assert_same_stream(g, c, phase):
    """Every CEAZCompressed field of the card's run equals the CPU run's."""
    import numpy as np
    for k in ("shape", "dtype", "ndim", "mode", "word_bits", "predictor"):
        check(getattr(g, k) == getattr(c, k), f"{phase}: {k} differs")
    check(len(g.chunks) == len(c.chunks), f"{phase}: chunk count differs")
    for i, (a, b) in enumerate(zip(g.chunks, c.chunks)):
        for k in ("n_values", "eb", "action", "chi", "codebook_id",
                  "center", "bank_ref", "bank_index"):
            check(getattr(a, k) == getattr(b, k),
                  f"{phase}: chunk {i} {k} differs")
        for k in ("words", "block_nbits", "outlier_idx", "outlier_delta"):
            x, y = getattr(a, k), getattr(b, k)
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"{phase}: chunk {i} {k} differs")
        la, lb = a.codebook_lengths, b.codebook_lengths
        check((la is None) == (lb is None)
              and (la is None or np.array_equal(la, lb)),
              f"{phase}: chunk {i} codebook_lengths differ")
    check(np.array_equal(g.literal_idx, c.literal_idx),
          f"{phase}: literal_idx differs")
    check(g.literal_val.tobytes() == c.literal_val.tobytes(),
          f"{phase}: literal_val differs")


def span_breakdown(fn, dispatch):
    """Total ms per span name over one traced call of fn, with the kernel
    passes synced so each `kernel.<op>` span holds its device time."""
    import torch
    from repro_torch.obs import trace as ot
    tracer = ot.enable()
    tracer.clear()
    dispatch.set_timing(True)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        dispatch.set_timing(False)
        ot.disable()
    totals = {}
    for ev in tracer.events():
        totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return {k: round(v, 3) for k, v in sorted(totals.items())}


def run_phase(name, x, kw, offline, dispatch, CEAZ, CEAZConfig, captured,
              census):
    """Counted main-path run on the card + the CPU run it must equal."""
    import numpy as np
    from repro_torch.core.dualquant import value_range
    from repro_torch.obs import metrics as om
    gpu = CEAZ(CEAZConfig(device="cuda", **kw), offline_codebook=offline)
    cpu = CEAZ(CEAZConfig(device="cpu", **kw), offline_codebook=offline)
    captured.clear()
    fallbacks = om.counter(om.BANK_FALLBACKS).value()
    before = om.snapshot()
    dispatch.reset_launches()
    census.start(name)
    c_gpu = gpu.compress(x)
    import torch
    torch.cuda.synchronize()
    counters = walk_counters()
    if counters:
        counters[0]()
    t0 = time.perf_counter()
    y_gpu = gpu.decompress(c_gpu)
    torch.cuda.synchronize()
    counted_dec_s = time.perf_counter() - t0
    counts = dispatch.launches()
    census.stop(counts)
    check_walk_counters(name, counts, counters)
    spec = om.diff(om.snapshot(), before)
    for k in PHASE_KERNELS[name]:
        check(counts.get(k, 0) > 0,
              f"phase {name}: kernel {k} was not launched ({counts})")
    if name in NO_SELECT_PHASES:
        check("bank_select" not in counts,
              f"phase {name}: the bank encode launched its select apart "
              f"({counts})")
    fell_back = om.counter(om.BANK_FALLBACKS).value() - fallbacks
    if name in DRIFT_PHASES:
        check(fell_back == 1
              and not any(ch.action == "bank" for ch in c_gpu.chunks),
              f"phase {name}: the bank route did not fall back to exact "
              f"codebooks ({fell_back} fallbacks)")
    elif kw.get("codebook") == "bank":
        check(fell_back == 0
              and all(ch.action == "bank" for ch in c_gpu.chunks),
              f"phase {name}: the bank route fell back to exact codebooks")
    check(c_gpu.predictor == kw.get("predictor", "lorenzo"),
          f"phase {name}: predictor {c_gpu.predictor}")
    inputs = dict(captured)
    t0 = time.perf_counter()
    c_cpu = cpu.compress(x)
    y_cpu = cpu.decompress(c_cpu)
    cpu_s = time.perf_counter() - t0
    assert_same_stream(c_gpu, c_cpu, f"phase {name}")
    check(y_gpu.tobytes() == y_cpu.tobytes(),
          f"phase {name}: decoded bytes differ from the CPU run")
    errs = np.abs(y_gpu.reshape(-1).astype(np.float64)
                  - x.reshape(-1).astype(np.float64))
    err = float(errs.max())
    if kw["mode"] == "fixed_ratio":
        # each chunk has its own bound; the ratio tracks the target
        bound = np.repeat([ch.eb for ch in c_gpu.chunks],
                          [ch.n_values for ch in c_gpu.chunks])
        check(bool(np.all(errs <= bound)),
              f"phase {name}: a value exceeds its chunk's bound")
        bound = f"per chunk {min(bound)}..{max(bound)}"
        target = kw["target_ratio"]
        check(abs(c_gpu.ratio() / target - 1) <= FIXED_RATIO_ENVELOPE,
              f"phase {name}: ratio {c_gpu.ratio()} is not within "
              f"{FIXED_RATIO_ENVELOPE:.0%} of the target {target}")
        if kw.get("speculation", "auto") != "off" \
                and kw.get("use_fused", True):
            print(f"phase {name}: speculation hits="
                  f"{spec.get(om.SPEC_HITS, 0)} misses="
                  f"{spec.get(om.SPEC_MISSES, 0)} final window="
                  f"{om.snapshot().get(om.SPEC_WINDOW)}")
    else:
        bound = kw["eb"] * value_range(x)
        check(err <= bound, f"phase {name}: max error {err} > bound "
              f"{bound}")
    enc_s = host_s(lambda: gpu.compress(x))
    if name in ONE_DECODE_PHASES:
        dec_s = counted_dec_s
        traced, what = (lambda: gpu.compress(x)), "compress"
    else:
        dec_s = host_s(lambda: gpu.decompress(c_gpu))
        traced = lambda: gpu.decompress(gpu.compress(x))
        what = "round trip"
    gb = x.nbytes / 1e9
    print(f"phase {name} spans (ms, one traced {what}, kernel passes "
          f"synced): {span_breakdown(traced, dispatch)}")
    print(f"phase {name}: shape={x.shape} chunks={len(c_gpu.chunks)} "
          f"predictor={c_gpu.predictor} "
          f"actions={sorted({ch.action for ch in c_gpu.chunks})} "
          f"ratio={c_gpu.ratio()} max_err={err} bound={bound} "
          f"literals={len(c_gpu.literal_idx)} launches={counts} "
          f"stream+bytes==cpu run: True (cpu run {cpu_s:.2f} s)")
    return counts, inputs, dict(compress_GBps=gb / enc_s,
                                decompress_GBps=gb / dec_s,
                                compress_s=enc_s, decompress_s=dec_s,
                                decompress_samples=(
                                    1 if name in ONE_DECODE_PHASES else 3)), \
        (c_gpu, y_gpu)


def run_split_phase(name, c, y_mega, kw, offline, dispatch, CEAZ, CEAZConfig,
                    captured):
    """Counted split-route decode on the card of a stream the megakernel
    route decoded to `y_mega` (which equals the CPU run's bytes)."""
    import torch
    split = CEAZ(CEAZConfig(device="cuda", decode_megakernel="split", **kw),
                 offline_codebook=offline)
    captured.clear()
    counters = walk_counters()
    if counters:
        counters[0]()
    dispatch.reset_launches()
    y = split.decompress(c)
    torch.cuda.synchronize()
    counts = dispatch.launches()
    check_walk_counters(name, counts, counters)
    check(counts.get("hufdec", 0) > 0,
          f"phase {name}: kernel hufdec was not launched ({counts})")
    for k in SPLIT_FORBIDDEN:
        check(counts.get(k, 0) == 0,
              f"phase {name}: the split route launched {k} ({counts})")
    check(y.tobytes() == y_mega.tobytes(),
          f"phase {name}: split-route bytes differ from the megakernel "
          "route's")
    dec_s = host_s(lambda: split.decompress(c))
    print(f"phase {name}: chunks={len(c.chunks)} launches={counts} "
          f"bytes==megakernel route==cpu run: True decompress "
          f"{y.nbytes / 1e9 / dec_s} GB/s ({dec_s} s)")
    return counts, dict(captured), dict(decompress_GBps=y.nbytes / 1e9
                                        / dec_s, decompress_s=dec_s)


def add_row(rows, name, cuda_fn, plain_fn, in_bytes, out_bytes, ops,
            extra=None, library_ms=None, time_plain=True):
    """One kernel's row: bitwise against its plain version, timed, with
    its bound from the bytes and operations of these inputs, the L2-cold
    device time of everything one call puts on the device
    (``cold_device_ms``) and the bound's share of it, and the wrapper's
    host side."""
    import torch
    got = cuda_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    check(same_outputs(got, want),
          f"kernel {name} disagrees with its plain version")
    ms = cuda_ms(cuda_fn)
    plain_ms = cuda_ms(plain_fn, reps=3, warmup=1) if time_plain else None
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    faults = len(PROFILE_FAULTS)
    device_ms = cold_device_ms(cuda_fn, bound_ms=max(t_bytes, t_ops),
                               what=f"kernel {name}")
    if len(PROFILE_FAULTS) > faults:
        extra = dict(extra or {}, device_ms_null=PROFILE_FAULTS[-1][1])
    rows[name] = r = dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=REPLACES[name], launches=0, max_abs_err=0,
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms, device_ms=device_ms,
        pct_of_bound=pct_of_bound(max(t_bytes, t_ops), device_ms),
        host_ms=host_call_ms(cuda_fn), **(extra or {}))
    print(f"kernel {name}: bitwise == plain: True  ms={ms} "
          f"plain_ms={plain_ms} bound_ms={r['bound_ms']} "
          f"({r['bound_by']}; {in_bytes + out_bytes} B, {ops} ops) "
          f"library_ms={library_ms} device_ms(L2-cold)={r['device_ms']} "
          f"pct_of_bound={r['pct_of_bound']} host_ms={r['host_ms']}")


def kernel_rows(inputs):
    """Each kernel on its main-path inputs: bitwise vs plain, timed."""
    from repro_torch.kernels.dualquant import ops as DQ
    from repro_torch.kernels.megakernel import ops as MK
    rows = {}
    inputs_a, inputs_b = inputs["A"], inputs["B"]

    def row(*a, **kw):
        add_row(rows, *a, **kw)

    for name, inp in (("dq2d", inputs_a), ("dq1d", inputs_b)):
        work, eb, ndim, n_out = inp["dualquant"][0]
        n = work.numel()
        row(name, lambda: DQ.dual_quantize_cuda(work, eb, ndim, n_out),
            lambda: DQ.dual_quantize_plain(work, eb, ndim, n_out),
            in_bytes=4 * n, out_bytes=9 * n_out + 4 * n,
            ops=(4 if ndim == 2 else 2) * 12 * n)

    # -- the bank encode's kernels alone (phases D, E, F) ------------------
    # prequantize is ~12 f32 operations a value (rows 9 and 13: op_rows,
    # center_rows)
    work2, prev2, valid2, ebs = inputs["D"]["ceaz_chunk"][0][:4]
    C, cv = work2.shape
    row("lorenzo_tiles",
        lambda: MK.lorenzo_quant_cuda(work2, prev2, valid2, ebs),
        lambda: MK.lorenzo_quant_plain(work2, prev2, valid2, ebs),
        in_bytes=nbytes(work2, prev2, valid2, ebs),
        out_bytes=13 * C * cv + 4 * NUM_SYMBOLS * C, ops=24 * C * cv,
        extra=dict(phase="D"))

    # the standalone select (phase F's bank pass) on phase C's histograms
    args_c = inputs["C"]["ceaz_chunk"][0]
    ln, cw = args_c[4:6]
    hists_c = MK.lorenzo_quant_cuda(*args_c[:4])[4]
    K = ln.shape[0]
    row("bank_select", lambda: MK.bank_select_cuda(hists_c, ln, cw),
        lambda: MK.bank_select_plain(hists_c, ln, cw),
        in_bytes=nbytes(hists_c, ln, cw),
        out_bytes=hists_c.shape[0] * (8 + 8 * NUM_SYMBOLS),
        ops=2 * K * NUM_SYMBOLS * hists_c.shape[0], extra=dict(phase="C"))

    work2, _, valid2, ebs = inputs["E.bank"]["ceaz_chunk"][0][:4]
    C, cv = work2.shape
    row("value_quant_tiles", lambda: MK.value_quant_cuda(work2, ebs),
        lambda: MK.value_quant_plain(work2, ebs),
        in_bytes=nbytes(work2, ebs), out_bytes=4 * C * cv, ops=12 * C * cv,
        extra=dict(phase="E.bank"))
    q2 = MK.value_quant_cuda(work2, ebs)
    centers = DQ.dq_center_cuda(q2, valid2)
    row("value_finalize_tiles",
        lambda: MK.value_finalize_cuda(q2, valid2, centers),
        lambda: MK.value_finalize_plain(q2, valid2, centers),
        in_bytes=nbytes(q2, valid2, centers),
        out_bytes=13 * C * cv + 4 * NUM_SYMBOLS * C, ops=4 * C * cv,
        extra=dict(phase="E.bank"))
    return rows


class Sight:
    """First-sight holds of the phases that keep no arguments
    (SIGHT_PHASES): a call whose (phase, wrapper, key) is new is held
    bitwise against its plain version on the card right after it
    returns, in row slices of at most SIGHT_VALUES values where its rows
    are independent, and its arguments dropped. Records each held key
    under every kernel its call launched; `seconds` is the time the
    holds took (their device syncs included), which the phases take out
    of the save seconds they report."""

    def __init__(self):
        import threading
        self.phase, self.seen, self.by_kernel = None, set(), {}
        self.seconds = 0.0
        self.lock = threading.RLock()

    def call(self, what, key, fn, plain, rows, a):
        phase = self.phase
        if phase is None or (phase, what, key) in self.seen:
            return fn(*a)
        import torch
        from repro_torch.kernels import dispatch
        with self.lock:
            before = dispatch.launches()
            out = fn(*a)
            after = dispatch.launches()
            t0 = time.perf_counter()
            held_in_rows(out, plain, a, rows,
                         f"{what} at phase {phase}'s {key}")
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.seen.add((phase, what, key))
            for k, n in after.items():
                if n > before.get(k, 0):
                    self.by_kernel.setdefault(k, []).append(
                        [phase, what, [str(x) for x in key]])
        return out

    def kernels(self, phase):
        """The kernels launched by the calls held in `phase`."""
        return {k for k, held in self.by_kernel.items()
                if any(h[0] == phase for h in held)}


SIGHT = Sight()


def held_in_rows(out, plain, a, rows, what):
    """`out`, a wrapper's outputs on the arguments `a`, bitwise against
    plain(*a): whole (`rows` None), or a slice of rows at a time, the
    arguments at the indices `rows` and every output cut to the same
    rows (each row's outputs depend on that row's inputs alone)."""
    out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if rows is None:
        check(same_outputs(out, plain(*a)),
              f"wrapper {what} disagrees with its plain version")
        return
    C = a[rows[0]].shape[0]
    check(all(o.shape[0] == C for o in out),
          f"wrapper {what}: an output is not one row a row of its input")
    step = max(1, SIGHT_VALUES // max(1, a[rows[0]][:1].numel()))
    for i in range(0, C, step):
        part = list(a)
        for j in rows:
            part[j] = a[j][i:i + step]
        check(same_outputs(tuple(o[i:i + step] for o in out), plain(*part)),
              f"wrapper {what} disagrees with its plain version in rows "
              f"{i}..{min(C, i + step) - 1}")


class Census:
    """One wrapped kernel wrapper's calls by key over the phases' counted
    runs: every call made between start(phase) and stop(). The first
    call's arguments at each key are kept for its held and timed case;
    in SIGHT_PHASES the call is held at first sight (SIGHT, with
    `plain` and the row arguments `rows`) and nothing is kept. With
    `count_name`, stop() checks that the census holds every launch the
    run counted under that name."""

    def __init__(self, name, key, plain, rows, count_name=None):
        self.name, self.key, self.count_name = name, key, count_name
        self.plain, self.rows = plain, rows
        self.live, self.phase, self.by_phase, self.args = None, None, {}, {}

    def wrap(self, fn):
        def counted(*a):
            if self.live is None:
                return fn(*a)
            k = self.key(self.phase, a)
            self.live[k] = self.live.get(k, 0) + 1
            if self.phase in SIGHT_PHASES:
                return SIGHT.call(self.name, k, fn, self.plain, self.rows, a)
            self.args.setdefault(k, (self.phase, a))
            return fn(*a)
        return counted

    def start(self, phase):
        self.live, self.phase = {}, phase

    def stop(self, launches):
        n = sum(self.live.values())
        if self.count_name is not None:
            want = launches.get(self.count_name, 0)
            check(n == want, f"phase {self.phase}: the {self.count_name} "
                  f"census holds {n} launches, the run counted {want}")
        if n:
            self.by_phase[self.phase] = self.live
        self.live = None

    def totals(self):
        out = {}
        for per in self.by_phase.values():
            for k, n in per.items():
                out[k] = out.get(k, 0) + n
        return out


class Censuses:
    """The censuses the counted runs keep: row 3's pack by (C, cv, w32);
    the bank encode op (row 9) by (predictor, C, cv, w32, block size);
    dq_center (row 13) by (phase, C, V), since its passes depend on the
    data; the large-chunk packer (row 7, one flat stream: held whole) by
    (n, block size). start() and stop() also open and close SIGHT's
    phase."""

    def __init__(self):
        from repro_torch.kernels.dualquant import ops as DQ
        from repro_torch.kernels.hufenc import ops as HE
        from repro_torch.kernels.megakernel import ops as MK
        self.pack = Census("encode_pack", lambda p, a: (
            a[0].shape[0], a[0].shape[1], a[5]), HE.encode_pack_plain,
            (0, 1, 2, 3), "gather_pack_tiled")
        self.op = Census("ceaz_chunk", lambda p, a: (
            a[8], a[0].shape[0], a[0].shape[1], a[7], a[6]),
            MK.ceaz_chunk_plain, (0, 1, 2, 3))
        self.center = Census("dq_center", lambda p, a: (
            p, a[0].shape[0], a[0].shape[1]), DQ.chunk_center_plain, (0, 1),
            "dq_center")
        self.flat = Census("hufenc_flat", lambda p, a: (a[0].numel(), a[3]),
                           HE.hufenc_plain if hasattr(HE, "hufenc_cuda")
                           else HE.hufenc_blocks_plain, None, "hufenc")
        self.all = (self.pack, self.op, self.center, self.flat)

    def start(self, phase):
        for c in self.all:
            c.start(phase)
        SIGHT.phase = phase if phase in SIGHT_PHASES else None

    def stop(self, launches):
        SIGHT.phase = None
        for c in self.all:
            c.stop(launches)


def census_rows(census, rows, name, what, case, main_phase=None, keep=()):
    """`name`'s row at every key of its census: case(key, phase, args)
    adds the row for one key (held bitwise, timed L2-cold) and returns
    it. The key first launched in `main_phase` (else the first phase) is
    the row, the others its cases; beside them the launch-weighted device
    time and gap to the bound over all the census's launches."""
    totals = census.totals()
    print(f"{what} census, key -> launches over the counted runs: {totals}; "
          f"by phase: {census.by_phase}")
    order = list(census.by_phase)
    sight = [(p, k) for p, per in census.by_phase.items()
             if p in SIGHT_PHASES for k in per]
    unheld = [(p, k) for p, k in sight
              if (p, census.name, k) not in SIGHT.seen]
    check(not unheld, f"{what}: keys of the serving phases not held at "
          f"first sight: {unheld}")
    if sight:
        print(f"{what}: (phase, key) held bitwise at first sight in the "
              f"serving phases after SERVE (not timed): {sight}")
    keys = sorted((k for k in totals if k in census.args),
                  key=lambda k: (census.args[k][0] != main_phase,
                                 order.index(census.args[k][0])))
    cases, weighted, gap = [], 0.0, 0.0
    for key in keys:
        phase, args = census.args[key]
        r = case(key, phase, args)
        r.update(phase=phase, key=[str(k) for k in key],
                 key_launches=totals[key])
        cases.append(dict(r))
        if r["device_ms"] is not None:
            weighted += totals[key] * r["device_ms"]
            gap += totals[key] * (r["device_ms"] - r["bound_ms"])
    keep = CASE_KEYS + ("key", "key_launches") + keep
    timed = sum(n for k, n in totals.items() if k in census.args)
    rows[name] = dict(
        cases[0], cases=[{k: c.get(k) for k in keep} for c in cases[1:]],
        launch_weighted_device_ms=weighted, launch_weighted_gap_ms=gap,
        launches_at_timed_keys=timed)
    print(f"{what} over its census: {sum(totals.values())} launches at "
          f"{len(totals)} keys, {timed} of them at the {len(keys)} keys "
          f"timed: launch-weighted device ms {weighted}, launches x "
          f"(device ms - bound) {gap}")


def pack_rows(census, rows):
    """Row 3 at every shape where the counted runs launched it (the
    census), each held bitwise against encode_pack_plain and timed
    L2-cold: phase A's shape is the row, the others its cases (the plain
    version, and row 6's op on the same inputs, timed at A and B only)."""
    from repro_torch.kernels.hufenc import ops as HE

    def case(key, phase, args):
        codes2, valid2, ln, cw, bs, w32 = args
        C, cv = codes2.shape
        add_row(rows, "gather_pack_tiled", lambda: HE.encode_pack_cuda(*args),
                lambda: HE.encode_pack_plain(*args),
                in_bytes=nbytes(codes2, valid2, ln, cw),
                out_bytes=4 * C * (w32 + -(-cv // bs)),
                ops=int(valid2.sum()) * 8, extra=dict(shape=list(key)),
                time_plain=phase in ("A", "B"))
        r = rows["gather_pack_tiled"]
        if phase in ("A", "B"):
            # row 6's op (the same kernel since the two share it; the
            # one-program-per-chunk design in an earlier tree) on row 3's
            # inputs
            check(same_outputs(HE.gather_pack_cuda(*args),
                               HE.encode_pack_plain(*args)),
                  f"kernel gather_pack disagrees with its plain version at "
                  f"{phase}'s pass-2 shapes")
            r["gather_pack_device_ms"] = cold_device_ms(
                lambda: HE.gather_pack_cuda(*args))
            print(f"kernel gather_pack at {phase}'s pass-2 shapes: bitwise "
                  f"== plain: True device_ms(L2-cold)="
                  f"{r['gather_pack_device_ms']}")
        return r

    census_rows(census, rows, "gather_pack_tiled",
                "row 3 (gather_pack_tiled), (C, cv, w32)", case,
                main_phase="A", keep=("shape", "gather_pack_device_ms"))


def op_rows(census, rows):
    """Row 9, the bank encode op (quantize, select and pack; on value
    rows value_quant and dq_center first), at every (predictor, C, cv,
    w32, block size) where the counted runs called it: phase C's call is
    the row. Bound: the op's inputs and outputs once; prequantize is ~12
    f32 operations a value, run once (twice at a warp's edge), and the
    select 2 K 1024 integer operations a row."""
    from repro_torch.kernels.megakernel import ops as MK

    def case(key, phase, args):
        work2, prev2, valid2, ebs, ln, cw, bs, w32, pred = args
        C, cv = work2.shape
        K = ln.shape[0]
        per_row_out = 4 * (NUM_SYMBOLS + 4 + w32 + -(-cv // bs))
        add_row(rows, "ceaz_chunk_fused", lambda: MK.ceaz_chunk_cuda(*args),
                lambda: MK.ceaz_chunk_plain(*args),
                in_bytes=nbytes(work2, prev2, valid2, ebs, ln, cw),
                out_bytes=13 * C * cv + C * per_row_out,
                ops=24 * C * cv + 2 * K * NUM_SYMBOLS * C,
                time_plain=phase == "C")
        return rows["ceaz_chunk_fused"]

    census_rows(census, rows, "ceaz_chunk_fused",
                "row 9 (the ceaz_chunk op), (predictor, C, cv, w32, bs)",
                case, main_phase="C")


def center_rows(census, rows):
    """Row 13, dq_center, at every (phase, C, V) where the counted runs
    launched it (its passes depend on the data, so each phase is a case):
    phase E.bank's call is the row, beside two torch.kthvalue calls (the
    low and high middle ranks) on the same row and the sort the plain
    version makes. Prints each call's valid-key range per row, the
    quantity that sets the number of digit passes."""
    import torch
    from repro_torch.kernels.dualquant import ops as DQ

    def case(key, phase, args):
        q2, valid2 = args
        C, V = q2.shape
        big = torch.iinfo(torch.int32).max
        qmax = torch.where(valid2, q2, -big - 1).amax(dim=1).to(torch.int64)
        qmin = torch.where(valid2, q2, big).amin(dim=1).to(torch.int64)
        span = torch.where(valid2.any(dim=1), qmax - qmin, -1).tolist()
        print(f"dq_center at {phase} {tuple(q2.shape)}: valid-key range "
              f"(max - min) per row: {span}")
        extra = dict(key_range=[min(span), max(span)])
        library = None
        if phase == "E.bank":
            m = int(valid2.sum())
            qm = torch.where(valid2, q2, big)
            lo, hi = max(m - 1, 0) // 2 + 1, min(m // 2, V - 1) + 1

            def kth():
                return (torch.kthvalue(qm, lo, dim=1),
                        torch.kthvalue(qm, hi, dim=1))
            library = cuda_ms(kth)
            extra.update(sort_ms=cuda_ms(lambda: torch.sort(q2, dim=1)),
                         library_call="two torch.kthvalue (lo and hi ranks)",
                         library_device_ms=cold_device_ms(
                             kth, what="two torch.kthvalue at E.bank"))
        add_row(rows, "dq_center", lambda: DQ.dq_center_cuda(q2, valid2),
                lambda: DQ.chunk_center_plain(q2, valid2),
                in_bytes=nbytes(q2, valid2), out_bytes=4 * C,
                ops=8 * C * V, extra=extra, library_ms=library,
                time_plain=phase == "E.bank")
        return rows["dq_center"]

    census_rows(census, rows, "dq_center", "row 13 (dq_center), (phase, C, V)",
                case, main_phase="E.bank",
                keep=("key_range", "library_ms", "library_device_ms"))


# the warp walks: kernel -> (its phases, the main one first; the op whose
# captured call it takes; inputs it reads of the `ceaz_chunk_dec` op's 11
# arguments; ops a symbol). The split route's walk (`hufdec`, 7 arguments)
# is held in the same 11-argument form (as_dec_args).
WALKS = {
    "hufdec_tiles": (("A",) + tuple(
        p for p, ks in PHASE_KERNELS.items()
        if "hufdec_tiles" in ks and p != "A"), "ceaz_chunk_dec", 6, 12),
    "ceaz_chunk_dec_fused": (("B",) + tuple(
        p for p, ks in PHASE_KERNELS.items()
        if "ceaz_chunk_dec_fused" in ks and p != "B"), "ceaz_chunk_dec",
        10, 20),
    "hufdec": (tuple(SPLIT_PHASES.values()), "hufdec", 6, 12),
}
CASE_KEYS = ("phase", "ms", "device_ms", "pct_of_bound", "host_ms",
             "plain_ms", "bound_ms")


def as_dec_args(op, args):
    """A walk's captured call as the `ceaz_chunk_dec` op's 11 arguments:
    the `hufdec` op's 7 (the walk's 6, then the block size) padded with
    None where the decode metadata would be."""
    return list(args) if op == "ceaz_chunk_dec" \
        else list(args[:6]) + [None] * 4 + [args[6]]


def walk_fns(name):
    """(card, plain) of a walk kernel on the `ceaz_chunk_dec` op's 11
    arguments. The decode megakernel's plain version at any shape: the
    walk with one window a row, then the plain patch and inverse (what
    ceaz_chunk_dec_plain computes up to 2^17 values a row)."""
    from repro_torch.kernels.hufdec import ops as HD
    from repro_torch.kernels.megakernel import ops as MK
    if name == "hufdec_tiles":
        return (lambda d: HD.hufdec_tiles_cuda(*d[:6], d[10]),
                lambda d: HD.hufdec_tiles_plain(*d[:6], d[10]))
    if name == "hufdec":
        return (lambda d: HD.hufdec_cuda(*d[:6], d[10]),
                lambda d: HD.hufdec_plain(*d[:6], d[10]))

    def plain(d):
        codes = HD.walk_plain(*d[:6], d[10], d[1].shape[1], d[0].shape[1])
        return MK.patch_and_inverse(codes, d[2], *d[6:10])
    return (lambda d: MK.ceaz_chunk_dec_fused_cuda(*d)), plain


def counted_walks():
    """The walks whose counters the imported package keeps (a parent's,
    under --src, may keep fewer or none)."""
    from repro_torch.kernels.hufdec import ops as HD
    if not hasattr(HD, "walk_stats"):
        return ()
    kept = getattr(HD, "WARP_WALKS", ("hufdec_tiles", "ceaz_chunk_dec_fused"))
    return tuple(n for n in WALKS if n in kept)


def walk_counters():
    """(reset, read) of the imported package's warp-walk counters (blocks
    kept from the fast path, blocks walked by walk_lane, most sync
    rounds), or None for a tree without them (a parent's, under --src)."""
    from repro_torch.kernels.hufdec import ops as HD
    names = counted_walks()
    if not names:
        return None
    return HD.reset_walk_stats, lambda: {n: HD.walk_stats(n) for n in names}


def check_walk_counters(phase, launches, counters):
    """After a phase's counted decode of a valid stream: print the warp
    walks' counters and require that no block took walk_lane."""
    launched = [n for n in WALKS if launches.get(n, 0)]
    if not launched:
        return
    kept = counters[1]() if counters else {}
    missing = [n for n in launched if n not in kept]
    if missing:
        print(f"phase {phase} warp-walk counters of {missing}: not in this "
              "tree")
    got = {n: v for n, v in kept.items() if n in launched}
    if not got:
        return
    print(f"phase {phase} warp-walk counters (blocks kept from the fast "
          f"path, blocks walked by walk_lane, most sync rounds): {got}")
    check(all(v["exact_blocks"] == 0 and v["fast_blocks"] > 0
              for v in got.values()),
          f"phase {phase}: a block of a valid stream took walk_lane ({got})")


def walk_rows(inputs, rows):
    """Rows 4, 5 and 8: held bitwise against the plain version and timed
    at every phase where they launch (the main phase's numbers are the
    row's; the others are its cases; the plain version timed at the main
    phase only)."""
    for name, (phases, op, n_in, ops) in WALKS.items():
        cuda, plain = walk_fns(name)
        cases = []
        for phase in phases:
            dec = as_dec_args(op, inputs[phase][op][0])
            C, NB = dec[1].shape
            bs = dec[10]
            add_row(rows, name, lambda: cuda(dec), lambda: plain(dec),
                    in_bytes=nbytes(*dec[:n_in]), out_bytes=4 * C * NB * bs,
                    ops=ops * int(dec[2].sum()),
                    extra=dict(phase=phase, shape=[C, NB, bs]),
                    time_plain=phase == phases[0])
            cases.append(dict(rows[name]))
        rows[name] = dict(cases[0], cases=[
            {k: c[k] for k in CASE_KEYS + ("shape",)} for c in cases[1:]])


def add_case(rows, name, cuda_fn, plain_fn, **kw):
    """add_row for one more case of `name`'s row: the row stays (or the
    case becomes it, where there is none yet) and the case goes into its
    cases."""
    row = rows.get(name)
    add_row(rows, name, cuda_fn, plain_fn, **kw)
    if row is not None:
        case = rows[name]
        rows[name] = row
        row.setdefault("cases", []).append(
            {k: case.get(k) for k in CASE_KEYS + ("shape",)})


def serve_kernel_rows(inputs, rows):
    """Phase SERVE's kernels that no census holds at its shapes, held
    bitwise against their plain versions at the calls SERVE gave them,
    each a case of its row (plain versions not timed): every tiled
    decode walk of its restores (row 4, timed once a (C, NB, bs)), the
    value-direct quantize and finalize (rows 11-12) at the save's first
    group of 2^20-value chunks, and the save's first Lorenzo quantize
    (row 2) and histogram (row 14)."""
    from repro_torch.kernels.dualquant import ops as DQ
    from repro_torch.kernels.histogram import ops as HG
    from repro_torch.kernels.megakernel import ops as MK
    inp = inputs["SERVE"]
    cuda, plain = walk_fns("hufdec_tiles")
    timed = []
    for a in inp["ceaz_chunk_dec.kept"]:
        d = as_dec_args("ceaz_chunk_dec", a)
        C, NB = d[1].shape
        bs = d[10]
        if (C, NB, bs) in timed:
            check(same_outputs(cuda(d), plain(d)),
                  f"kernel hufdec_tiles disagrees with its plain version at "
                  f"SERVE's walk of {(C, NB, bs)}")
            continue
        timed.append((C, NB, bs))
        add_case(rows, "hufdec_tiles", lambda: cuda(d), lambda: plain(d),
                 in_bytes=nbytes(*d[:6]), out_bytes=4 * C * NB * bs,
                 ops=12 * int(d[2].sum()),
                 extra=dict(phase="SERVE", shape=[C, NB, bs]),
                 time_plain=False)
    print(f"kernel hufdec_tiles at phase SERVE: "
          f"{len(inp['ceaz_chunk_dec.kept'])} walks bitwise == plain: True; "
          f"timed at {timed}")

    work2, ebs = inp["value_quant.kept"][0]
    valid2 = inp["value_finalize.kept"][0][1]
    C, cv = work2.shape
    add_case(rows, "value_quant_tiles", lambda: MK.value_quant_cuda(work2, ebs),
             lambda: MK.value_quant_plain(work2, ebs),
             in_bytes=nbytes(work2, ebs), out_bytes=4 * C * cv,
             ops=12 * C * cv, extra=dict(phase="SERVE", shape=[C, cv]),
             time_plain=False)
    q2 = MK.value_quant_cuda(work2, ebs)
    centers = DQ.dq_center_cuda(q2, valid2)
    add_case(rows, "value_finalize_tiles",
             lambda: MK.value_finalize_cuda(q2, valid2, centers),
             lambda: MK.value_finalize_plain(q2, valid2, centers),
             in_bytes=nbytes(q2, valid2, centers),
             out_bytes=13 * C * cv + 4 * NUM_SYMBOLS * C, ops=4 * C * cv,
             extra=dict(phase="SERVE", shape=[C, cv]), time_plain=False)

    # the leaves the save's "auto" choice gave Lorenzo (none may, on
    # other weights)
    if "dualquant" in inp:
        work, eb, ndim, n_out = inp["dualquant"][0]
        n = work.numel()
        add_case(rows, f"dq{ndim}d",
                 lambda: DQ.dual_quantize_cuda(work, eb, ndim, n_out),
                 lambda: DQ.dual_quantize_plain(work, eb, ndim, n_out),
                 in_bytes=4 * n, out_bytes=9 * n_out + 4 * n,
                 ops=(4 if ndim == 2 else 2) * 12 * n,
                 extra=dict(phase="SERVE", shape=list(work.shape)),
                 time_plain=False)
    if "histogram" in inp:
        codes2, valid2 = inp["histogram"][0]
        C, n = codes2.shape
        add_case(rows, "histogram",
                 lambda: HG.histogram_cuda(codes2, valid2),
                 lambda: HG.histogram_plain(codes2, valid2),
                 in_bytes=nbytes(codes2, valid2),
                 out_bytes=4 * C * NUM_SYMBOLS, ops=2 * C * n,
                 extra=dict(phase="SERVE", shape=[C, n]), time_plain=False)


def walk_garbage_checks(inputs):
    """The walks on corrupted inputs, bitwise against their plain
    versions: garbage at small shapes (random words, random tables with
    length-0 entries, random bit counts and counts, as
    tests/test_torch_gpu.py::_garbage) through all three, and bit flips
    in the streams of phase A (hufdec_tiles), B (the decode megakernel)
    and S.A (hufdec). With the counters, some garbage blocks of each
    counted walk must have taken walk_lane; a bit-flipped block may pass
    the exact rule, so the bit flips' counters are printed, not
    checked."""
    import numpy as np
    import torch
    counters = walk_counters()
    rng = np.random.default_rng(2)
    cases = []
    for C, NB, bs in ((3, 6, 256), (2, 600, 256), (5, 40, 32)):
        W = int(rng.integers(3, 40))
        g = [rng.integers(-2**31, 2**31, (C, W)),
             rng.integers(0, 1 << 12, (C, NB)),
             rng.integers(0, NB * bs + 1, C),
             rng.integers(0, 1024, 1 << 17), rng.integers(0, 17, 1 << 17),
             rng.integers(0, 2, C), rng.integers(-999, 999, (C, 4)),
             rng.integers(-5, 6, C), np.zeros(C), rng.integers(0, 2, C)]
        d = [torch.from_numpy(a.astype(np.int32)).cuda() for a in g]
        cases.append((f"garbage {C}x{NB}x{bs}", tuple(WALKS), d + [bs]))
    for phase, name in (("A", "hufdec_tiles"), ("B", "ceaz_chunk_dec_fused"),
                        ("S.A", "hufdec")):
        op = WALKS[name][1]
        d = as_dec_args(op, inputs[phase][op][0])
        w = d[0].clone()
        used = (d[1].to(torch.int64).sum(1) + 31) // 32     # payload words
        for c in range(0, w.shape[0], max(1, w.shape[0] // 4)):
            for k in (1, 2):                 # a third and two thirds in
                w[c, int(used[c]) * k // 3] ^= 1 << (7 * (c + k) % 31)
        cases.append((f"bitflips in {phase}'s stream", (name,), [w] + d[1:]))
    exact = {}                   # walk_lane blocks on the garbage alone
    kept = counted_walks()
    for what, names, d in cases:
        for name in names:
            cuda, plain = walk_fns(name)
            if counters:
                counters[0]()
            got = cuda(d)
            # the counters of this one call, before the second
            st = counters[1]()[name] if name in kept else "not in this tree"
            check(same_outputs(got, cuda(d)) and same_outputs(got, plain(d)),
                  f"kernel {name} disagrees with its plain version on {what}")
            if name in kept and what.startswith("garbage"):
                exact[name] = exact.get(name, 0) + st["exact_blocks"]
            print(f"kernel {name} on {what}: twice bitwise == plain: True; "
                  f"counters of one call {st}")
    check(all(exact.get(n, 0) > 0 for n in kept),
          f"no garbage block took walk_lane: {exact}")


def window_checks(inputs, rows):
    """The fixed-ratio phases' launches at their own shapes and per-row
    bounds, held bitwise against the plain versions: a window's Lorenzo
    quantize (G) and bank encode (G.bank), and a sequential chunk's dq1d
    (G.off)."""
    from repro_torch.kernels.dualquant import ops as DQ
    from repro_torch.kernels.megakernel import ops as MK
    lq = inputs["G"]["lorenzo_quant"][0]
    bank = inputs["G.bank"]["ceaz_chunk"][0]
    dq = inputs["G.off"]["dualquant"][0]
    for what, args, cuda_fn, plain_fn, row, key in (
            ("window Lorenzo quantize (G)", lq, MK.lorenzo_quant_cuda,
             MK.lorenzo_quant_plain, "ceaz_chunk_fused", "window_ms"),
            ("window bank encode (G.bank)", bank, MK.ceaz_chunk_cuda,
             MK.ceaz_chunk_plain, "ceaz_chunk_fused", "bank_window_ms"),
            ("sequential chunk (G.off)", dq, DQ.dual_quantize_cuda,
             DQ.dual_quantize_plain, "dq1d", "chunk_ms")):
        check(same_outputs(cuda_fn(*args), plain_fn(*args)),
              f"kernel {row} disagrees with its plain version at the "
              f"{what} shapes")
        rows[row][key] = cuda_ms(lambda: cuda_fn(*args))
        print(f"kernel {row} at the {what} shapes {tuple(args[0].shape)}: "
              f"bitwise == plain: True  ms={rows[row][key]}")


def nonfinite_check():
    """dq1d/dq2d on NaN/+-Inf/+-3e9: PTX's float->int cast is not relied
    on, but the kernels' outputs must equal the plain version's."""
    import numpy as np
    import torch
    from repro_torch.kernels.dualquant import ops as DQ
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal(3 * 4096)).astype(np.float32)
    x[::7] = np.nan
    x[1::11] = np.inf
    x[2::13] = -np.inf
    x[3::17] = 3e9
    x[4::19] = -3e9
    for shape in ((x.size,), (3, 4096)):
        w = torch.from_numpy(x.reshape(shape)).cuda()
        got = DQ.dual_quantize_cuda(w, 1e-3, len(shape), x.size + 5)
        want = DQ.dual_quantize_plain(w.cpu(), 1e-3, len(shape), x.size + 5)
        check(same_outputs([t.cpu() for t in got], list(want)),
              f"dq{len(shape)}d disagrees with plain on non-finite inputs")
    print("dq1d/dq2d on NaN/+-Inf/+-3e9 inputs == plain (cpu): True")


def center_corner_check():
    """dq_center on rows with ties, no valid entry, a wrapping midpoint
    and values near +-2^31, against the plain version on the CPU."""
    import numpy as np
    import torch
    from repro_torch.kernels.dualquant import ops as DQ
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(1)
    V = 70001
    edge = rng.choice([i32.min, i32.min + 1, i32.max - 1, i32.max], V)
    wrap = np.zeros(V, np.int64)
    wrap[:2] = (-2_000_000_000, 2_000_000_000)
    q2 = np.stack([rng.integers(-3, 4, V), wrap, edge, edge,
                   rng.integers(-9, 9, V), np.full(V, 5)]).astype(np.int32)
    valid2 = np.stack([np.ones(V, bool), np.arange(V) < 2, np.ones(V, bool),
                       rng.random(V) < 0.5, np.zeros(V, bool),
                       np.arange(V) < 4])
    q, v = torch.from_numpy(q2), torch.from_numpy(valid2)
    got = DQ.dq_center_cuda(q.cuda(), v.cuda()).cpu()
    check(torch.equal(got, DQ.chunk_center_plain(q, v)),
          "dq_center disagrees with plain on ties/empty/wrap/+-2^31 rows")
    print(f"dq_center on tie/empty/wrap/+-2^31 rows == plain (cpu): True "
          f"{got.tolist()}")


# -- the fixed-width wire path (phases P, Q, Q.snap) ---------------------------

N_RANKS = 4
N_PODS = 4
Q_STEPS = 3
GATHER_PHASES = (("P.b8", 8, False), ("P.b8.lorenzo", 8, True),
                 ("P.b4", 4, False), ("P.b4.lorenzo", 4, True))
# gemma3-1b (src/repro/configs/gemma3_1b.py): d_model 1152, 4 q heads and 1
# kv head of 256, d_ff 6912, qk-norm and sandwich norms; the leaves of one
# layer as the reference's transformer names them (attn_init, mlp_init,
# norm_init). Cut: 24 of 26 layers and the 262144 x 1152 embedding.
D, H, KV, HD, FF = 1152, 4, 1, 256, 6912
GEMMA_LAYER = {
    "attn": {"wq": (D, H, HD), "wk": (D, KV, HD), "wv": (D, KV, HD),
             "wo": (H, HD, D), "q_norm": {"scale": (HD,)},
             "k_norm": {"scale": (HD,)}},
    "ln1": {"scale": (D,)}, "ln1_post": {"scale": (D,)},
    "ln2": {"scale": (D,)}, "ln2_post": {"scale": (D,)},
    "mlp": {"wi": (D, FF), "wg": (D, FF), "wo": (FF, D)}}
Q_LAYERS = 2
SNAP_LEAVES = ("layers/0/attn/wq", "layers/0/attn/wk", "layers/0/attn/wo",
               "layers/0/mlp/wi", "layers/0/ln1/scale")


def gemma_leaf_shapes():
    """{keystr path: shape} of Q_LAYERS gemma3-1b layers, in the
    reference's leaf order."""
    import types
    from repro_torch.convert import tree_items
    wrap = lambda node: ({k: wrap(v) for k, v in node.items()}
                         if isinstance(node, dict)
                         else types.SimpleNamespace(shape=node))
    tree = {"layers": [wrap(GEMMA_LAYER) for _ in range(Q_LAYERS)]}
    return {k: v.shape for k, v in tree_items(tree)}


def device_breakdown(name, fn, top=5, host_ops=True):
    """One call of fn under torch.profiler: wall ms (host clock, ending in
    a sync), the summed device time of its kernels, the device's idle
    share of the wall time, and the kernels with the most device time.
    ``host_ops=False`` records the device's activity alone (a train
    step's ~10^5 host ops would slow the call and the profiler's
    report)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kern.append((us / 1e3, e.count, e.key))
    kern.sort(reverse=True)
    dev_ms = sum(k[0] for k in kern)
    out = dict(wall_ms=wall, device_ms=dev_ms if kern else None,
               idle_share=(1 - dev_ms / wall) if kern else None,
               launches=sum(k[1] for k in kern),
               top=[dict(ms=k[0], n=k[1], kernel=k[2][:80])
                    for k in kern[:top]])
    print(f"profile {name}: wall {wall} ms, device "
          f"{out['device_ms'] if kern else 'not measured'} ms in "
          f"{out['launches']} kernels, idle share {out['idle_share']}; "
          f"top {out['top']}")
    return out


def run_gather_phases(fields, dispatch, captured, dev):
    """Phases P: counted gather on `dev`, then the checks against the
    port's CPU run and the derived bounds. -> (counts, inputs, stats)."""
    import numpy as np
    import torch
    from repro_torch.io import collectives as COL
    from repro_torch.optim import grad_compress as GC
    x = np.stack(fields)                               # (ranks, *field)
    xc = torch.from_numpy(x)
    xg = xc.to(dev)
    n = x[0].size
    counts, inputs, stats = {}, {}, {}
    for name, bits, lor in GATHER_PHASES:
        wire = COL.WireFormat(bits=bits, use_lorenzo=lor)
        captured.clear()
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        dec = COL.compressed_all_gather(xg, wire, device=dev)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        counts[name] = dispatch.launches()
        inputs[name] = dict(captured)
        for k in ("pack", "unpack"):
            check(counts[name].get(k, 0) > 0,
                  f"phase {name}: kernel {k} was not launched "
                  f"({counts[name]})")
        # the wire: words and scales against the CPU run, bit for bit
        x2g, x2c = xg.reshape(N_RANKS, n), xc.reshape(N_RANKS, n)
        words, scales = COL._encode_local(x2g, bits, lor)
        words_c, scales_c = COL._encode_local(x2c, bits, lor)
        check(same_outputs((words.cpu(), scales.cpu()), (words_c, scales_c)),
              f"phase {name}: words or scales differ from the CPU run")
        dec_c = COL.compressed_all_gather(xc, wire, device="cpu")
        dec = dec.cpu().reshape(N_RANKS, n).numpy()
        rh = GC.dequantize_rows(
            GC.BP.unpack_words(words, words.numel() * (32 // bits), bits)
            .reshape(N_RANKS, -1)[:, :n], scales, bits).cpu().numpy()
        worst, worst_bound, max_err = 0.0, 0.0, 0.0
        for r in range(N_RANKS):
            sc, xr = float(scales_c[r]), x[r].reshape(-1)
            err = np.abs(dec[r].astype(np.float64) - xr)
            max_err = max(max_err, float(err.max()))
            if not lor:
                bound = COL.step_bound(sc, np.abs(xr).max())
                check(float(err.max()) <= bound,
                      f"phase {name}: rank {r} max error {err.max()} > "
                      f"{bound} (0.5*scale + 2^-23*max|x|)")
                continue
            S, scan, open_loop = COL.lorenzo_bounds(
                xr, rh[r], sc, COL.sqrt_block(n))
            for which, d in (("card", dec[r]),
                             ("cpu", dec_c[r].reshape(-1).numpy())):
                dev_err = np.abs(d.astype(np.float64) - S)
                check(bool(np.all(dev_err <= scan)),
                      f"phase {name}: rank {r} {which} decode off the "
                      f"float64 prefix sum by more than the scan bound")
                if which == "card":
                    abs_sum = np.cumsum(np.abs(rh[r].astype(np.float64)))
                    worst = max(worst, float(np.max(
                        dev_err / np.maximum(2.0 ** -24 * abs_sum,
                                             1e-300))))
                    worst_bound = max(worst_bound, float(np.max(
                        dev_err / np.maximum(scan, 1e-300))))
            check(bool(np.all(err <= open_loop)),
                  f"phase {name}: rank {r} error over the open-loop bound")
        if not lor:
            check(dec.tobytes() == dec_c.numpy().tobytes(),
                  f"phase {name}: decoded bytes differ from the CPU run")
        wire_b = COL.wire_bytes(N_RANKS, n, bits)
        stats[name] = dict(s=s, wire_bytes=wire_b, raw_bytes=int(x.nbytes),
                           wire_fraction=wire_b / x.nbytes, max_err=max_err,
                           scale=[float(v) for v in scales_c])
        stats[name]["s_median"] = host_s(
            lambda: COL.compressed_all_gather(xg, wire, device=dev))
        stats[name]["profile"] = device_breakdown(
            name, lambda: COL.compressed_all_gather(xg, wire, device=dev))
        if lor:
            stats[name]["scan_err_over_u_sum"] = worst
            stats[name]["scan_err_over_bound"] = worst_bound
            print(f"phase {name}: worst |decode - float64 prefix sum| / "
                  f"(2^-24 * sum|r^|) on the card = {worst}, "
                  f"{worst_bound} of the scan bound (blocked_cumsum, "
                  f"block {COL.sqrt_block(n)})")
        print(f"phase {name}: {x.shape} bits={bits} lorenzo={lor} "
              f"words+scales == cpu run: True{'' if lor else ', bytes too'} "
              f"{stats[name]} launches={counts[name]}")
    return counts, inputs, stats


def _q_state(dev, seed):
    """Params (dense_init-like normals, norms zero) for the Q leaves."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {}
    for k, shape in gemma_leaf_shapes().items():
        if k.endswith("/scale"):
            params[k] = torch.zeros(shape, device=dev)
        else:
            params[k] = torch.randn(shape, generator=gen, device=dev) \
                * shape[0] ** -0.5
    return params


def _q_grads(dev, seed, step):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + step + 1)
    return {k: torch.randn((N_PODS,) + tuple(shape), generator=gen,
                           device=dev) * 1e-3
            for k, shape in gemma_leaf_shapes().items()}


def run_exchange_phase(dispatch, captured, dev, seed):
    """Phase Q: 3 counted steps of the exchange and AdamW on `dev`, params
    and gradients made from `seed`; after each, the same step on the CPU
    from the card's inputs: means and residuals bitwise, AdamW within
    ``adamw.step_deviation``."""
    import torch
    from repro_torch.kernels.bitpack import ops as BP
    from repro_torch.optim import adamw as PA
    from repro_torch.optim import grad_compress as GC
    ccfg, acfg = GC.CompressionConfig(bits=8), PA.AdamWConfig()
    params = _q_state(dev, seed)
    opt = PA.adamw_init(params, acfg, device=dev)
    # the error-feedback residuals, one per pod on the leading axis
    res = {k: torch.zeros((N_PODS,) + tuple(p.shape), device=dev)
           for k, p in params.items()}
    res_c = {k: r.cpu() for k, r in res.items()}
    n_vals = N_PODS * sum(p.numel() for p in params.values())
    wire = sum(N_PODS * (4 * BP.words_len(p.numel(), ccfg.bits) + 4)
               for p in params.values())
    steps, flips, worst_p, gn_dev = [], 0, 0.0, 0.0
    counts = {}
    captured.clear()
    for step in range(Q_STEPS):
        grads = _q_grads(dev, seed, step)
        p_before = {k: v.cpu() for k, v in params.items()}
        o_before = {"mu": {k: v.cpu() for k, v in opt["mu"].items()},
                    "nu": {k: v.cpu() for k, v in opt["nu"].items()},
                    "step": opt["step"].cpu()}
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        res_prev = res
        mean, res = GC.compressed_cross_pod_mean(grads, res, ccfg,
                                                 device=dev)
        t1 = time.perf_counter()
        params, opt, om = PA.adamw_update(params, mean, opt, acfg,
                                          device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for k, v in dispatch.launches().items():
            counts[k] = counts.get(k, 0) + v
        # the CPU run of the same step from the same inputs
        grads_c = {k: g.cpu() for k, g in grads.items()}
        mean_c, res_c = GC.compressed_cross_pod_mean(grads_c, res_c, ccfg,
                                                     device="cpu")
        for k in mean:
            check(same_outputs((mean[k].cpu(), res[k].cpu()),
                               (mean_c[k], res_c[k])),
                  f"phase Q step {step}: pod mean or residual of {k} "
                  f"differs from the CPU run")
        new_p, new_o, om_c = PA.adamw_update(p_before, mean_c, o_before,
                                             acfg, device="cpu")
        # each global norm against the float64 one; the clip bound from
        # that norm and the two norms' checked deviations from it
        gn_g, gn_c = float(om["grad_norm"]), float(om_c["grad_norm"])
        exact, gn_err = PA.norm_error(mean_c)
        check(abs(gn_g - exact) <= gn_err and abs(gn_c - exact) <= gn_err,
              f"phase Q step {step}: global norms {gn_g} (card), {gn_c} "
              f"(cpu) off the float64 {exact} by more than {gn_err}")
        gn_dev = max(gn_dev, abs(gn_g - exact) / gn_err,
                     abs(gn_c - exact) / gn_err)
        rho = PA.clip_rho(exact, (gn_g, gn_c), acfg)
        clip = PA.clip_factor(exact, acfg)
        for k in mean_c:
            b = PA.step_deviation(p_before[k], mean_c[k], o_before["mu"][k],
                                  o_before["nu"][k], step + 1, acfg, clip,
                                  rho)
            d = (params[k].cpu().to(torch.float64)
                 - new_p[k].to(torch.float64)).abs()
            check(bool((d <= b["p"]).all()),
                  f"phase Q step {step}: params of {k} off the CPU run by "
                  f"more than step_deviation")
            worst_p = max(worst_p, float((d / b["p"]).max()))
            for m in ("mu", "nu"):
                nf, ok = PA.bf16_moment_check(b[m + "32"], b[m],
                                              opt[m][k].cpu(), new_o[m][k])
                check(ok, f"phase Q step {step}: {m} of {k} differs beyond "
                      "its f32 bound around a bf16 rounding boundary")
                flips += nf
        steps.append(dict(exchange_s=t1 - t0, step_s=t2 - t0,
                          grad_norm=gn_g, lr=float(om["lr"])))
        print(f"phase Q step {step}: {t2 - t0} s (exchange {t1 - t0} s) "
              f"grad_norm={gn_g} wire fraction {wire / (4 * n_vals)} of "
              f"f32 ({wire} B) means+residuals == cpu run: True")
    for k in ("pack", "unpack"):
        check(counts.get(k, 0) > 0,
              f"phase Q: kernel {k} was not launched ({counts})")
    # where a step's time goes: the last step's exchange and update again
    prof = dict(exchange=device_breakdown(
        "Q exchange", lambda: GC.compressed_cross_pod_mean(
            grads, res_prev, ccfg, device=dev)),
        adamw=device_breakdown("Q adamw", lambda: PA.adamw_update(
            params, mean, opt, acfg, device=dev)))
    stats = dict(profile=prof, values=n_vals, leaves=len(params), steps=steps,
                 wire_bytes=wire, wire_fraction_f32=wire / (4 * n_vals),
                 wire_fraction_bf16=wire / (2 * n_vals),
                 adamw_worst_param_dev_over_bound=worst_p,
                 grad_norm_worst_dev_over_bound=gn_dev,
                 bf16_moment_flips=flips)
    print(f"phase Q: {n_vals} gradient values in {len(params)} leaves x "
          f"{N_PODS} pods, {Q_STEPS} steps, global norms within "
          f"norm_error (worst {gn_dev} of it), AdamW params within "
          f"step_deviation (worst {worst_p} of it), {flips} bf16 moments "
          f"off the CPU run at a rounding boundary; launches={counts}")
    return counts, dict(captured), stats, mean


def run_snapshot_phase(mean, dispatch, dev, census):
    """Phase Q.snap: five pod-mean leaves through snapshot_grads and
    restore_grad_snapshot on the card, against the CPU run."""
    import numpy as np
    import torch
    from repro_torch.core import CEAZCompressed
    from repro_torch.core.dualquant import value_range
    from repro_torch.optim import grad_compress as GC
    leaves = {k: mean[k] for k in SNAP_LEAVES}
    host = {k: v.cpu().numpy() for k, v in leaves.items()}
    torch.cuda.synchronize()
    dispatch.reset_launches()
    census.start("Q.snap")
    snap = GC.snapshot_grads(leaves, device=dev)
    back = GC.restore_grad_snapshot(snap, device=dev)
    torch.cuda.synchronize()
    counts = dispatch.launches()
    census.stop(counts)
    check(counts.get("gather_pack_tiled", 0) > 0
          and counts.get("hufdec_tiles", 0)
          + counts.get("ceaz_chunk_dec_fused", 0) > 0,
          f"phase Q.snap: the facade's kernels did not launch ({counts})")
    snap_c = GC.snapshot_grads(host, device="cpu")
    back_c = GC.restore_grad_snapshot(snap_c, device="cpu")
    ratios = {}
    for k in SNAP_LEAVES:
        check(back[k].tobytes() == back_c[k].tobytes(),
              f"phase Q.snap: {k} decodes to other bytes than the CPU run")
        if isinstance(snap[k], CEAZCompressed):
            assert_same_stream(snap[k], snap_c[k], f"phase Q.snap {k}")
            bound = 1e-3 * value_range(host[k])
            err = float(np.abs(back[k].astype(np.float64)
                               - host[k]).max())
            check(err <= bound, f"phase Q.snap: {k} error {err} > {bound}")
            ratios[k] = (snap[k].ratio(), snap[k].predictor)
        else:
            check(back[k].tobytes() == host[k].tobytes(),
                  f"phase Q.snap: raw leaf {k} changed")
            ratios[k] = "raw"
    print(f"phase Q.snap: {len(SNAP_LEAVES)} leaves, records+bytes == cpu "
          f"run: True {ratios} launches={counts}")
    return counts


def wire_checks():
    """The bitpack kernels on every width, odd lengths, out-of-range values
    and a misaligned view, and a NaN/Inf leaf through the exchange,
    against the plain versions on the CPU."""
    import numpy as np
    import torch
    from repro_torch.kernels.bitpack import ops as BP
    from repro_torch.optim import grad_compress as GC
    rng = np.random.default_rng(0)
    for bits in (2, 4, 8, 16):
        for n in (1, 4097, 1000003):
            v = rng.integers(-(1 << 20), 1 << 20, n + 1).astype(np.int32)
            v[::3] &= (1 << bits) - 1
            for q in (torch.from_numpy(v[:n]).cuda(),
                      torch.from_numpy(v).cuda()[1:]):
                qc = q.cpu()
                w = BP.pack_words_cuda(q, bits)
                t = BP.pack_flat_cuda(q, bits)
                check(same_outputs(
                    [x.cpu() for x in (w, t, BP.unpack_words_cuda(w, n, bits),
                                       BP.unpack_flat_cuda(t, n, bits),
                                       BP.unpack_cuda(t, bits))],
                    [BP.pack_words_plain(qc, bits),
                     BP.pack_flat_plain(qc, bits),
                     BP.unpack_words_plain(w.cpu(), n, bits),
                     BP.unpack_flat_plain(t.cpu(), n, bits),
                     BP.unpack_plain(t.cpu(), bits)]),
                      f"bitpack kernels disagree with plain at bits={bits} "
                      f"n={n}")
    print("pack/unpack (both layouts) on b=2,4,8,16, odd lengths, "
          "out-of-range values, a misaligned view == plain (cpu): True")
    g = {k: torch.from_numpy(rng.standard_normal((4,) + s).astype(
        np.float32)) for k, s in (("w", (33, 70)), ("nan", (129,)),
                                  ("inf", (3, 5)))}
    g["nan"][2, 3] = float("nan")
    g["inf"][0, 1, 1] = float("-inf")
    cfg = GC.CompressionConfig(bits=8)
    got = GC.compressed_cross_pod_mean(g, GC.ef_init(g, device="cuda"), cfg)
    want = GC.compressed_cross_pod_mean(g, GC.ef_init(g, device="cpu"), cfg,
                                        device="cpu")
    for k in g:
        check(same_bits_or_nan(got[0][k].cpu(), want[0][k])
              and same_bits_or_nan(got[1][k].cpu(), want[1][k]),
              f"exchange of the {k} leaf differs from the CPU run")
    check(bool(torch.isnan(got[0]["nan"]).all()
               and torch.isnan(got[0]["inf"]).all()),
          "a NaN/Inf leaf did not decode to NaN")
    print("exchange with a NaN leaf and an Inf leaf == cpu run, NaN "
          "throughout: True")


def wire_kernel_rows(inputs, rows):
    """pack and unpack at the main path's shapes: the row's numbers at
    Q's largest leaf in the wire (consecutive) layout; P's, and the TPU
    kernel's tile layout at both, as cases."""
    import torch
    from repro_torch.kernels.bitpack import ops as BP
    where = [("Q", inputs["Q"])] + [(p, inputs[p]) for p, _, _ in
                                    GATHER_PHASES[::2]]
    for kernel, op in (("pack", "pack_words"), ("unpack", "unpack_words")):
        cases = []
        for phase, inp in where:
            args = inp[op][0]
            bits = args[-1]
            if kernel == "pack":
                q = args[0]
                n = q.numel()
                layouts = (("words", BP.pack_words_cuda, BP.pack_words_plain,
                            (q, bits)),
                           ("tile", BP.pack_flat_cuda, BP.pack_flat_plain,
                            (q, bits)))
            else:
                w, n = args[0], args[1]
                tile = BP.pack_flat_cuda(BP.unpack_words_cuda(w, n, bits),
                                         bits)
                layouts = (("words", BP.unpack_words_cuda,
                            BP.unpack_words_plain, (w, n, bits)),
                           ("tile", BP.unpack_flat_cuda,
                            BP.unpack_flat_plain, (tile, n, bits)))
            for layout, cuda_fn, plain_fn, a in layouts:
                got = cuda_fn(*a)
                check(same_outputs(got, plain_fn(*a)),
                      f"kernel {kernel} ({layout} layout) disagrees with "
                      f"its plain version at {phase}'s shapes")
                ms = cuda_ms(lambda: cuda_fn(*a))
                plain_ms = cuda_ms(lambda: plain_fn(*a), reps=3, warmup=1)
                nbytes_ = 4 * n + n * bits // 8
                bound = nbytes_ / HBM_BYTES_PER_S * 1e3
                dev = cold_device_ms(lambda: cuda_fn(*a), bound_ms=bound,
                                     what=f"kernel {kernel} at {phase}")
                cases.append(dict(phase=phase, layout=layout, values=n,
                                  bits=bits, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, max_abs_err=0,
                                  device_ms=dev,
                                  pct_of_bound=pct_of_bound(bound, dev),
                                  host_ms=host_call_ms(lambda: cuda_fn(*a))))
                print(f"kernel {kernel} {layout} layout at {phase} ({n} "
                      f"values, {bits} bits): bitwise == plain: True "
                      f"{cases[-1]} (bytes; {nbytes_} B)")
        main = cases[0]
        rows[kernel] = dict(
            name=kernel, route="cuda", source=SOURCES[kernel],
            replaces=REPLACES[kernel], launches=0, max_abs_err=0,
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by="bytes", library_ms=None,
            device_ms=main["device_ms"], pct_of_bound=main["pct_of_bound"],
            host_ms=main["host_ms"], phase="Q", layout="words",
            cases=cases[1:])


# -- the staged route and compress_batch (phases T, BATCH) ---------------------

N_SHARDS = 4


def staged_packers(n):
    """The kernels the staged route packs an n-value chunk with, by the
    rule of the imported package (``encode_device``): a parent's rule may
    draw the line elsewhere."""
    from repro_torch.kernels.hufenc import ops as HE
    return (("gather_pack",) if n <= HE.GATHER_PACK_MAX_VALUES
            else ("hufenc",))


def run_batch_phases(field, offline, dispatch, CEAZ, CEAZConfig, captured,
                     census):
    """BATCH (fused) and BATCH.staged: the field as N_SHARDS shards through
    ``compress_batch`` and ``decompress_batch`` on the card, counted; each
    shard's stream equals the CPU run's and its own ``compress``'s, the
    decoded bytes the CPU run's. -> (counts, inputs, throughput)."""
    import numpy as np
    import torch
    from repro_torch.core.dualquant import value_range
    shards = list(field.reshape(N_SHARDS, -1))
    counts, inputs, thr, outs = {}, {}, {}, {}
    for name, kw in (("BATCH", {}), ("BATCH.staged", dict(use_fused=False))):
        cfg = dict(mode="rel", eb=1e-4, **kw)
        gpu = CEAZ(CEAZConfig(device="cuda", **cfg), offline_codebook=offline)
        cpu = CEAZ(CEAZConfig(device="cpu", **cfg), offline_codebook=offline)
        captured.clear()
        torch.cuda.synchronize()
        dispatch.reset_launches()
        census.start(name)
        c_gpu = gpu.compress_batch(shards)
        counters = walk_counters()
        if counters:
            counters[0]()
        y_gpu = gpu.decompress_batch(c_gpu)
        torch.cuda.synchronize()
        counts[name] = dispatch.launches()
        census.stop(counts[name])
        check_walk_counters(name, counts[name], counters)
        inputs[name] = dict(captured)
        want = PHASE_KERNELS[name] + (staged_packers(shards[0].size)
                                      if name == "BATCH.staged" else ())
        for k in want:
            check(counts[name].get(k, 0) > 0,
                  f"phase {name}: kernel {k} was not launched "
                  f"({counts[name]})")
        if name == "BATCH":
            check(counts[name]["histogram"] == 1
                  and counts[name]["gather_pack_tiled"] == 1,
                  f"phase BATCH: not one pass pair ({counts[name]})")
        c_cpu = cpu.compress_batch(shards)
        y_cpu = cpu.decompress_batch(c_cpu)
        for i, s in enumerate(shards):
            assert_same_stream(c_gpu[i], c_cpu[i], f"phase {name} shard {i}")
            assert_same_stream(c_gpu[i], gpu.compress(s),
                               f"phase {name} shard {i} vs its own compress")
            check(y_gpu[i].tobytes() == y_cpu[i].tobytes(),
                  f"phase {name} shard {i}: decoded bytes differ from the "
                  "CPU run")
            err = float(np.abs(y_gpu[i].astype(np.float64) - s).max())
            check(err <= 1e-4 * value_range(s),
                  f"phase {name} shard {i}: max error {err} over the bound")
        outs[name] = c_gpu
        enc_s = host_s(lambda: gpu.compress_batch(shards))
        dec_s = host_s(lambda: gpu.decompress_batch(c_gpu))
        gb = field.nbytes / 1e9
        thr[name] = dict(compress_GBps=gb / enc_s, decompress_GBps=gb / dec_s,
                         compress_s=enc_s, decompress_s=dec_s,
                         decompress_samples=3)
        print(f"phase {name}: {N_SHARDS} shards of {shards[0].size} "
              f"chunks={[len(c.chunks) for c in c_gpu]} ratios="
              f"{[c.ratio() for c in c_gpu]} launches={counts[name]} "
              "streams==cpu run==own compress, bytes==cpu run: True")
    for i in range(N_SHARDS):
        assert_same_stream(outs["BATCH.staged"][i], outs["BATCH"][i],
                           f"phase BATCH.staged shard {i} vs BATCH")
    print("phase BATCH.staged streams == BATCH streams: True")
    return counts, inputs, thr


def launch_floor():
    """An empty kernel launched through the kernels' ctypes binding
    (csrc/empty.cu), timed as a row is: ms by CUDA events (the floor
    under a row's ms at a small shape) and its device ms. None where the
    imported tree's library has no such entry (a parent's, under --src)."""
    import ctypes
    from repro_torch.kernels import _build, dispatch
    if not hasattr(_build.library(), "ceaz_empty_launch"):
        return None
    fn = _build.function("ceaz_empty_launch", [ctypes.c_void_p])

    def call():
        _build.check(fn(dispatch.stream_handle()), "empty launch")
    return dict(ms=cuda_ms(call),
                device_ms=cold_device_ms(call),
                host_ms=host_call_ms(call))


def row7_calls(HE, codes, ln, cw, bs):
    """Row 7 on (codes, lengths, cwords, block size) through the imported
    tree's wrappers -> (total bits, card call, plain call), each call
    giving (stream words, block bits): the one-launch `hufenc_cuda`, or a
    parent's `hufenc_blocks_cuda` + `stitch_cuda` (rows as wide as a
    block at the book's longest code)."""
    import torch
    total = int(ln.to(torch.int64)[codes.to(torch.int64)
                                   .clamp(0, NUM_SYMBOLS - 1)].sum())
    if hasattr(HE, "hufenc_cuda"):
        return (total, lambda: HE.hufenc_cuda(codes, ln, cw, bs, total),
                lambda: HE.hufenc_plain(codes, ln, cw, bs, total))
    max_len = int(ln.max())

    def two(blocks, stitch):
        rows, nbits = blocks(codes, ln, cw, bs, max_len)
        return stitch(rows, nbits, total), nbits
    return (total, lambda: two(HE.hufenc_blocks_cuda, HE.stitch_cuda),
            lambda: two(HE.hufenc_blocks_plain, HE.stitch_plain))


def row7_device_check(fn, what):
    """A row-7 call puts one kernel (hufenc_kernel) and one memset on the
    device and counts one `hufenc` launch (a parent's two kernels and
    torch glue: printed, not checked). A profiler session now and then
    records no device event, or not all of them (seen on the card, about
    once in a few hundred sessions), so up to five sessions are read: one
    whose every call is that kernel and that memset settles it; events
    the call does put on the device show in every session."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.hufenc import ops as HE
    dispatch.reset_launches()
    fn()
    launched = dispatch.launches()

    def one_kernel_one_memset(call):
        return (len(call) == 2
                and sum("hufenc_kernel" in n for n in call) == 1
                and sum("memset" in n.lower() for n in call) == 1)
    mine = hasattr(HE, "hufenc_cuda")
    for _ in range(5):
        names = [[n for n, _ in c] for c in profiled_calls(fn, reps=3)]
        if names and (not mine
                      or all(one_kernel_one_memset(c) for c in names)):
            break
    print(f"row 7 at {what}: launches {launched}, device events of a "
          f"call {names[0] if names else None}")
    if not mine:
        return
    check(launched == {"hufenc": 1},
          f"row 7 at {what}: a call counted {launched}")
    check(names and all(one_kernel_one_memset(c) for c in names),
          f"row 7 at {what}: a call is not one kernel and one memset: "
          f"{names}")


def flat_rows(census, rows):
    """Row 7 at every (n, block size) where the counted runs called it
    (T.A's call is the row), held bitwise against its plain version and
    timed L2-cold, each call checked to be one kernel and one memset.
    Bound: the codes and the book read once, the payload and the block
    bits written once, ~8 integer operations a value."""
    from repro_torch.kernels.hufenc import ops as HE

    def case(key, phase, args):
        codes, ln, cw, bs = args[:4]
        total, cuda, plain = row7_calls(HE, codes, ln, cw, bs)
        row7_device_check(cuda, f"{phase}'s chunk {key}")
        add_row(rows, "hufenc", cuda, plain,
                in_bytes=nbytes(codes, ln, cw),
                out_bytes=total // 8 + 4 * -(-codes.numel() // bs),
                ops=8 * codes.numel(),
                extra=dict(values=codes.numel(), total_bits=total),
                time_plain=phase == "T.A")
        return rows["hufenc"]

    census_rows(census, rows, "hufenc", "row 7 (hufenc), (n, block size)",
                case, main_phase="T.A", keep=("values", "total_bits"))


def staged_kernel_rows(inputs, census, rows):
    """The three kernels the staged route brought, on the main path's
    inputs: `histogram` at B's and A's calls and at one row of T.G (2^15
    values) and of G.off (2^17), each beside the torch.bincount call it
    replaces; `gather_pack` at T.G's chunk; `hufenc` (row 7) at every
    chunk of its census (T.A, T.E, BATCH.staged); both packers held
    against each other and timed at 2^15, 2^16, 2^22, 2^22+1 and 2^23 of
    T.E's codes (2^15 and 2^16 the two sides of encode_device's rule); an
    empty launch, the floor under the one-row cases. Every case of `histogram` and the packers has ms
    (events, warm, host included), device_ms (its kernels and zeroing,
    L2-cold) and host_ms (the wrapper's host side) beside its bound."""
    import torch
    from repro_torch.kernels.histogram import ops as HG
    from repro_torch.kernels.hufenc import ops as HE
    cases = []
    for phase in ("B", "A", "T.G", "G.off"):
        codes2, valid2 = inputs[phase]["histogram"][0]
        C, n = codes2.shape
        # the one bincount _chunk_hists made before the kernel, its row
        # keys built beforehand
        keys = torch.where(valid2, codes2.to(torch.int64) + NUM_SYMBOLS
                           * torch.arange(C, device=codes2.device)[:, None],
                           C * NUM_SYMBOLS).reshape(-1)
        lib = cuda_ms(lambda: torch.bincount(keys,
                                             minlength=C * NUM_SYMBOLS + 1))
        add_row(rows, "histogram", lambda: HG.histogram_cuda(codes2, valid2),
                lambda: HG.histogram_plain(codes2, valid2),
                in_bytes=nbytes(codes2, valid2), out_bytes=4 * C * NUM_SYMBOLS,
                ops=2 * C * n, extra=dict(phase=phase, shape=[C, n]),
                library_ms=lib)
        cases.append(dict(rows["histogram"]))
    keep = ("phase", "shape", "ms", "device_ms", "pct_of_bound", "host_ms",
            "plain_ms", "bound_ms", "library_ms")
    rows["histogram"] = dict(cases[0], cases=[{k: c[k] for k in keep}
                                              for c in cases[1:]])

    args = inputs["T.G"]["gather_pack"][0]
    codes2, valid2, ln, cw, bs, w32 = args
    add_row(rows, "gather_pack", lambda: HE.gather_pack_cuda(*args),
            lambda: HE.encode_pack_plain(*args),
            in_bytes=nbytes(codes2, valid2, ln, cw),
            out_bytes=4 * (w32 + -(-codes2.shape[1] // bs)),
            ops=8 * codes2.numel(),
            extra=dict(phase="T.G", values=codes2.shape[1]))

    flat_rows(census, rows)

    op = next(op for op in ROW7_OPS if op in inputs["T.E"])
    codes, ln, cw, bs = inputs["T.E"][op][0][:4]
    crossover = []
    for n in (1 << 15, 1 << 16, 1 << 22, (1 << 22) + 1, codes.numel()):
        c = codes[:n]
        tot, hb, _ = row7_calls(HE, c, ln, cw, bs)
        n32 = 2 * ((tot + 63) // 64 + 1)
        one = torch.ones((1, n), dtype=torch.bool, device=c.device)
        gp = lambda: HE.gather_pack_cuda(c[None], one, ln[None], cw[None],
                                         bs, n32)
        words, nbits = gp()
        check(same_outputs((words[0], nbits[0]), hb()),
              f"gather_pack and hufenc disagree at {n} values")
        check(same_outputs((words, nbits), HE.encode_pack_plain(
            c[None], one, ln[None], cw[None], bs, n32)),
            f"kernel gather_pack disagrees with its plain version at {n} "
            "values")
        bound = (nbytes(c, one, ln, cw) + 4 * (n32 + nbits.numel())) \
            / HBM_BYTES_PER_S * 1e3
        gp_dev = cold_device_ms(gp, bound_ms=bound,
                                what=f"gather_pack at {n} values")
        crossover.append(dict(
            values=n, gather_pack_ms=cuda_ms(gp), hufenc_ms=cuda_ms(hb),
            gather_pack_device_ms=gp_dev,
            hufenc_device_ms=cold_device_ms(hb),
            gather_pack_host_ms=host_call_ms(gp),
            hufenc_host_ms=host_call_ms(hb),
            bound_ms=bound, pct_of_bound=pct_of_bound(bound, gp_dev)))
        print(f"packers at {n} values of T.E's codes: gather_pack == "
              f"hufenc == plain: True {crossover[-1]}")
    rows["gather_pack"]["crossover"] = crossover

    floor = launch_floor()
    print(f"launch floor, an empty kernel through ctypes: "
          f"{floor if floor else 'not in this tree'}")
    for name in ("histogram", "gather_pack"):
        rows[name]["launch_floor"] = floor


# -- the .ceazs stream engine and the file write (phases W) -------------------

def counted_run(name, fn, dispatch, census, captured, also=()):
    """fn() on the card with the launch counts set to 0 just before and
    read just after, inside the censuses; every kernel of the phase (and
    of `also`) must have launched, and no block of its valid streams may
    take walk_lane. -> (fn's result, counts, the ops' captured inputs)."""
    import torch
    torch.cuda.synchronize()
    counters = walk_counters()
    if counters:
        counters[0]()
    captured.clear()
    dispatch.reset_launches()
    census.start(name)
    out = fn()
    torch.cuda.synchronize()
    counts = dispatch.launches()
    census.stop(counts)
    inputs = dict(captured)
    check_walk_counters(name, counts, counters)
    for k in PHASE_KERNELS[name] + tuple(also):
        check(counts.get(k, 0) > 0,
              f"phase {name}: kernel {k} was not launched ({counts})")
    if name in SIGHT_PHASES:
        # every decode call is kept and held after the run
        unheld = {k for k, n in counts.items() if n} \
            - SIGHT.kernels(name) - set(DECODE_WALKS)
        check(not unheld, f"phase {name}: kernels {sorted(unheld)} "
              f"launched by no call held at first sight ({counts})")
    return out, counts, inputs


def timed_calls(write, read):
    """write() then read(), each timed whole on the host clock between
    device syncs -> (write's result, read's result, write s, read s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = write()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = read()
    torch.cuda.synchronize()
    return st, back, t1 - t0, time.perf_counter() - t1


def stream_figures(name, st, write_call_s, read_call_s, card):
    """W's figures: write and read GB/s of raw input over the whole calls
    (the write's footer, fsync and rename, the read's self-configured
    facade included), and the engine's stage seconds beside them (its
    wall_s stops before the footer is written)."""
    gb = st["raw_bytes"] / 1e9
    out = {k: st[k] for k in ("wall_s", "compress_s", "serialize_s",
                              "write_s", "overlap_efficiency", "ratio",
                              "raw_bytes", "stored_bytes")}
    out.update(write_call_s=write_call_s, read_call_s=read_call_s,
               write_GBps=gb / write_call_s, read_GBps=gb / read_call_s)
    print(f"stream phase {name} [{card}]: write {out['write_GBps']} GB/s "
          f"({write_call_s} s), read {out['read_GBps']} GB/s "
          f"({read_call_s} s) of raw input, whole calls; engine wall "
          f"{out['wall_s']} s, compress_s {out['compress_s']}, serialize_s "
          f"{out['serialize_s']}, write_s {out['write_s']}, "
          f"overlap_efficiency {out['overlap_efficiency']}, ratio "
          f"{out['ratio']}")
    return out


def records_and_payloads(path):
    from repro_torch.io import engine as E
    with E.StreamReader(path) as r:
        return r.records, [r.payload(i) for i in range(len(r))]


def run_stream_phases(nyx, hacc, dispatch, census, captured, card, tmp):
    """Phases W, W.staged, W.bank and W.fuzz on the card, each counted;
    -> (counts, inputs, figures)."""
    import numpy as np
    from repro_torch.core import CEAZ, CEAZConfig
    from repro_torch.core.dualquant import value_range
    from repro_torch.io import engine as E
    from repro_torch.io import filewrite as FW
    counts, inputs, figs = {}, {}, {}
    comp = CEAZ(CEAZConfig(mode="rel", eb=1e-4, use_fused=True,
                           device="cuda"))

    # W: the paper's MPI_File_write, 4 Nyx ranks, default facade on the card
    d_w, d_sync = os.path.join(tmp, "w"), os.path.join(tmp, "w_sync")

    def write_read():
        return timed_calls(
            lambda: FW.parallel_compressed_write(d_w, nyx, overlap=True,
                                                 fsync=True),
            lambda: FW.parallel_read(d_w))
    (st, back, write_s, read_s), counts["W"], inputs["W"] = counted_run(
        "W", write_read, dispatch, census, captured)
    recs, pays = records_and_payloads(os.path.join(d_w, FW.DUMP_NAME))
    check(len(recs) == len(nyx), "phase W: record count")
    # the card's 3-D path against the CPU's, which the CPU tests hold to
    # the reference's bytes: rank 0 (all four took ~26 s; the run's time)
    cpu = CEAZ(CEAZConfig(mode="rel", eb=1e-4, use_fused=True,
                          device="cpu"))
    t0 = time.perf_counter()
    for r, x in enumerate(nyx):
        c = comp.compress(x)
        check(pays[r] == E.serialize_payload(c)[0],
              f"phase W: rank {r}'s payload differs from the facade's "
              "compress on the card")
        want = comp.decompress(c).tobytes()
        if r == 0:
            c_cpu = cpu.compress(x)
            check(pays[r] == E.serialize_payload(c_cpu)[0],
                  f"phase W: rank {r}'s payload differs from the facade's "
                  "compress on the CPU")
            check(cpu.decompress(c_cpu).tobytes() == want,
                  "phase W: rank 0 decompresses to other bytes on the CPU")
        check(back[r].tobytes() == want,
              f"phase W: rank {r} reads back to other bytes than the "
              "facade's decompress on the card")
        err = float(np.abs(back[r].astype(np.float64) - x).max())
        check(err <= 1e-4 * value_range(x),
              f"phase W: rank {r} max error {err} over the bound")
    cpu_s = time.perf_counter() - t0
    FW.parallel_compressed_write(d_sync, nyx, overlap=False, fsync=True)
    check(records_and_payloads(os.path.join(d_sync, FW.DUMP_NAME))
          == (recs, pays), "phase W: overlap=False changed the records")
    files = []
    for sync in (True, False):
        path = os.path.join(tmp, f"w_telemetry_off_{sync}.ceazs")
        E.write_stream(path, nyx, comp, sync=sync, telemetry=False)
        with open(path, "rb") as f:
            files.append(f.read())
    check(files[0] == files[1],
          "phase W: write_stream sync=True and sync=False files differ")
    figs["W"] = stream_figures("W", st, write_s, read_s, card)
    print(f"phase W: {len(nyx)} ranks of {nyx[0].shape}, payloads == "
          "facade compress on the card (rank 0's == on the CPU), bytes == "
          "facade decompress (rank 0's on both), overlap=False records == "
          "overlap, sync "
          f"file == async file: True (cpu runs {cpu_s:.2f} s) "
          f"launches={counts['W']}")

    # W.staged: the staged route's dump of the HACC shards
    shards = list(hacc.reshape(N_SHARDS, -1))
    d_st = os.path.join(tmp, "w_staged")

    def staged():
        return timed_calls(
            lambda: FW.parallel_compressed_write(
                d_st, shards, comp=comp, use_fused=False, fsync=True),
            lambda: FW.parallel_read(d_st))
    (st, back, write_s, read_s), counts["W.staged"], inputs["W.staged"] = \
        counted_run("W.staged", staged, dispatch, census, captured,
                    also=staged_packers(shards[0].size))
    _, pays = records_and_payloads(os.path.join(d_st, FW.DUMP_NAME))
    for r, x in enumerate(shards):
        check(pays[r] == E.serialize_payload(comp.compress(x))[0],
              f"phase W.staged: shard {r}'s payload differs from the fused "
              "route's")
        err = float(np.abs(back[r].astype(np.float64) - x).max())
        check(err <= 1e-4 * value_range(x),
              f"phase W.staged: shard {r} max error {err} over the bound")
    figs["W.staged"] = stream_figures("W.staged", st, write_s, read_s,
                                      card)
    print(f"phase W.staged: {N_SHARDS} shards of {shards[0].size}, "
          f"payloads == fused route's: True launches={counts['W.staged']}")

    # W.bank: write_stream with the codebook bank, read back self-configured
    bank = CEAZ(CEAZConfig(mode="rel", eb=1e-4, codebook="bank",
                           device="cuda"))
    p_bank = os.path.join(tmp, "w_bank.ceazs")

    def banked():
        return timed_calls(
            lambda: E.write_stream(p_bank, shards, bank).as_dict(),
            lambda: E.read_stream_arrays(p_bank))
    (st, back, write_s, read_s), counts["W.bank"], inputs["W.bank"] = \
        counted_run("W.bank", banked, dispatch, census, captured)
    check("bank_select" not in counts["W.bank"],
          "phase W.bank: the bank encode launched its select apart")
    with E.StreamReader(p_bank) as r:
        check(r.meta.get("codebook_bank", {}).get("id") == bank.bank.id,
              "phase W.bank: the footer does not carry the bank")
        objs = [o for _, o in r.iter_objects()]
        check(all(min(rec["bank_delta"]) >= 0 for rec in r.records),
              "phase W.bank: a record's bank_delta left the bank")
    check(all(ch.action == "bank" for o in objs for ch in o.chunks),
          "phase W.bank: a chunk left the bank route")
    for r, x in enumerate(shards):
        check(back[r].tobytes() == bank.decompress(objs[r]).tobytes(),
              f"phase W.bank: shard {r} reads back to other bytes than the "
              "facade's decompress")
        err = float(np.abs(back[r].astype(np.float64) - x).max())
        check(err <= 1e-4 * value_range(x),
              f"phase W.bank: shard {r} max error {err} over the bound")
    figs["W.bank"] = stream_figures("W.bank", st, write_s, read_s, card)
    print(f"phase W.bank: every chunk on the bank route, footer bank "
          f"{bank.bank.id}: True launches={counts['W.bank']}")

    counts["W.fuzz"], inputs["W.fuzz"] = run_fuzz_phase(dispatch, census,
                                                        captured, tmp)
    return counts, inputs, figs


def run_fuzz_phase(dispatch, census, captured, tmp):
    """W.fuzz: a small stream written on the card; every stream-level case
    of the fuzz corpus must be judged corrupt by the card's mega, split
    and staged routes alike, and the pristine stream decode to the same
    bytes on all three."""
    import numpy as np
    from repro_torch.core import CEAZ, CEAZConfig
    from repro_torch.io import engine as E
    sys.path.insert(0, os.path.join(ROOT, "tests", "corpus"))
    from stream_cases import FUZZ_KW, apply_corpus_case, corpus_cases
    routes = [("mega", dict(decode_megakernel="mega")),
              ("split", dict(decode_megakernel="split")),
              ("staged", dict(use_fused=False))]
    comps = [(n, CEAZ(CEAZConfig(device="cuda", **FUZZ_KW, **kw)))
             for n, kw in routes]
    path = os.path.join(tmp, "fuzz.ceazs")
    shards = [np.cumsum(np.random.default_rng(4 + i).standard_normal(6000))
              .astype(np.float32) for i in range(3)]

    def verdicts():
        out = []
        for name, comp in comps:
            try:
                arrs = E.read_stream_arrays(path, comp, sync=True)
                out.append((name, "ok", tuple(a.tobytes() for a in arrs)))
            except E.StreamCorruptionError:
                out.append((name, "corrupt", None))
        return out

    def pristine():
        E.write_stream(path, shards, comps[0][1])
        return verdicts()
    clean, counts, inputs = counted_run("W.fuzz", pristine, dispatch,
                                        census, captured)
    check(all(v == "ok" for _, v, _ in clean)
          and len({b for _, _, b in clean}) == 1,
          f"phase W.fuzz: the pristine stream decodes differently "
          f"{[(n, v) for n, v, _ in clean]}")
    with E.StreamReader(path) as r:
        records = list(r.records)
    with open(path, "rb") as f:
        data = f.read()
    cases = corpus_cases(len(records))
    for case in cases:
        with open(path, "wb") as f:
            f.write(apply_corpus_case(data, records, case))
        got = verdicts()
        check(all(v == "corrupt" for _, v, _ in got),
              f"phase W.fuzz: {case} judged {[(n, v) for n, v, _ in got]}")
    print(f"phase W.fuzz: {len(cases)} corpus cases judged corrupt by the "
          "mega, split and staged routes; pristine bytes equal on all "
          f"three: True launches={counts}")
    return counts, inputs


# ---------------------------------------------------------------------------
# The .ceazs consumers: R (the gather through the Huffman codec), Q.stream
# (the gradient-snapshot streams), K (compressed checkpoints), V (the pager)
# ---------------------------------------------------------------------------

# the reference's ceaz_gather defaults: rel 1e-4, 2^20-value chunks, block
# 4096
GATHER_KW = dict(eb_rel=1e-4, chunk_values=1 << 20, block_size=4096)
PAGER_GETS = 64
# kernels whose launch shows a decode ran on the card (the walk the route
# picks depends on the chunk length)
DECODE_WALKS = ("hufdec_tiles", "ceaz_chunk_dec_fused")


def synced(fn):
    """fn() timed whole on the host clock between device syncs ->
    (result, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def batched_passes(fn):
    """fn() under the tracer -> (result, the n of every
    ceaz.batch_fused_pass span it opened)."""
    from repro_torch.obs import trace as ot
    tracer = ot.enable()
    tracer.clear()
    try:
        out = fn()
    finally:
        ot.disable()
    return out, [ev["args"]["n"] for ev in tracer.events()
                 if ev["name"] == "ceaz.batch_fused_pass"]


def check_decoded_on_card(phase, counts, encode=True):
    """The facade's kernels launched in a consumer phase: the pass-2 pack
    (for an encode) and one of the decode walks."""
    check((not encode or counts.get("gather_pack_tiled", 0) > 0)
          and any(counts.get(k, 0) > 0 for k in DECODE_WALKS),
          f"phase {phase}: the facade's kernels did not launch ({counts})")


def same_records(a, b, keys=None):
    """Two streams hold the same records under `keys` (all of a's when
    None): every index field but seq and offset, and the payload bytes."""
    from repro_torch.io import engine as E
    with E.StreamReader(a) as ra, E.StreamReader(b) as rb:
        keys = [r["key"] for r in ra.records] if keys is None else keys
        for k in keys:
            x = {f: v for f, v in ra.records[ra.seq_of(k)].items()
                 if f not in ("seq", "offset")}
            y = {f: v for f, v in rb.records[rb.seq_of(k)].items()
                 if f not in ("seq", "offset")}
            if x != y or ra.payload(ra.seq_of(k)) != rb.payload(
                    rb.seq_of(k)):
                return False
    return True


def consumer_figures(name, raw_bytes, calls, card):
    """Host-clock seconds and GB/s of raw input of a phase's whole calls
    ({what: seconds}), printed beside the card."""
    out = {f"{what}_s": s for what, s in calls.items()}
    out.update({f"{what}_GBps": raw_bytes / 1e9 / s
                for what, s in calls.items()})
    out["raw_bytes"] = raw_bytes
    print(f"consumer phase {name} [{card}]: " + ", ".join(
        f"{what} {s} s ({raw_bytes / 1e9 / s} GB/s)"
        for what, s in calls.items()) + " of raw input, whole calls, host "
        "clock after device syncs")
    return out


def run_gather_codec_phase(nyx, dispatch, census, captured, card, tmp):
    """Phase R: the paper's MPI_Gather through the Huffman codec, P's 4
    Nyx ranks on the card at the reference's defaults: ceaz_gather (ONE
    batched pass pair), ceaz_gather_decode, then ceaz_gather_stream and
    read_gather_stream. -> (counts, inputs, figures)."""
    import numpy as np
    from repro_torch.core import CEAZ, CEAZConfig
    from repro_torch.core.dualquant import value_range
    from repro_torch.io import collectives as COL
    path = os.path.join(tmp, "gather.ceazs")

    def run():
        (res, g_s), passes = batched_passes(
            lambda: synced(lambda: COL.ceaz_gather(nyx, **GATHER_KW)))
        back, d_s = synced(lambda: COL.ceaz_gather_decode(
            res[0], block_size=GATHER_KW["block_size"]))
        st, w_s = synced(lambda: COL.ceaz_gather_stream(nyx, path,
                                                        **GATHER_KW))
        (arrays, _), r_s = synced(lambda: COL.read_gather_stream(path))
        return res, passes, back, st, arrays, dict(
            gather=g_s, decode=d_s, stream_write=w_s, stream_read=r_s)
    (res, passes, back, st, arrays, calls), counts, inputs = counted_run(
        "R", run, dispatch, census, captured)
    (comps, stats) = res
    check(passes == [N_RANKS], f"phase R: batched passes {passes}, want "
          f"one of n={N_RANKS}")
    one = CEAZ(CEAZConfig(mode="rel", eb=GATHER_KW["eb_rel"],
                          chunk_bytes=4 * GATHER_KW["chunk_values"],
                          block_size=GATHER_KW["block_size"],
                          device="cuda"))
    for r, x in enumerate(nyx):
        assert_same_stream(comps[r], one.compress(x),
                           f"phase R rank {r} vs the card's compress")
    check(stats["raw_bytes"] == sum(x.nbytes for x in nyx)
          and stats["wire_bytes"] == sum(c.nbytes() for c in comps),
          f"phase R: stats {stats}")
    # the CPU run on rank 0 only (~6 s a rank): the whole smoke run stays
    # under ~550 s; the card's single compress above holds every rank
    t0 = time.perf_counter()
    cpu, _ = COL.ceaz_gather(nyx[:1], device="cpu", **GATHER_KW)
    assert_same_stream(comps[0], cpu[0], "phase R rank 0 vs the cpu")
    back_c = COL.ceaz_gather_decode(cpu, block_size=GATHER_KW["block_size"],
                                    device="cpu")
    cpu_s = time.perf_counter() - t0
    check(back[0].tobytes() == back_c[0].tobytes(),
          "phase R: rank 0 decodes to other bytes than the CPU run")
    for r, x in enumerate(nyx):
        check(back[r].tobytes() == arrays[r].tobytes(), f"phase R: rank {r} "
              "reads back from the gather stream to other bytes")
        err = float(np.abs(back[r].astype(np.float64) - x).max())
        check(err <= GATHER_KW["eb_rel"] * value_range(x),
              f"phase R: rank {r} max error {err} over the bound")
    # a ragged set: the last rank cut to 256x256x200 takes its own pass
    cut = nyx[-1].shape[2] * 25 // 32
    ragged = list(nyx[:-1]) + [np.ascontiguousarray(nyx[-1][:, :, :cut])]
    (rc, _), rpasses = batched_passes(
        lambda: COL.ceaz_gather(ragged, **GATHER_KW))
    check(rpasses == [N_RANKS - 1], f"phase R: ragged set batched "
          f"{rpasses}, want one pass of n={N_RANKS - 1}")
    for r in range(N_RANKS - 1):
        assert_same_stream(rc[r], comps[r], f"phase R ragged rank {r}")
    assert_same_stream(rc[-1], one.compress(ragged[-1]),
                       "phase R ragged last rank vs the card's compress")
    sync_path = os.path.join(tmp, "gather_sync.ceazs")
    COL.ceaz_gather_stream(nyx, sync_path, overlap=False, **GATHER_KW)
    check(same_records(path, sync_path)
          and records_and_payloads(path)[0] == records_and_payloads(
              sync_path)[0], "phase R: the sync gather stream's records "
          "differ from the overlapped one's")
    check(st["n_ranks"] == N_RANKS and st["raw_bytes"] == stats["raw_bytes"],
          f"phase R: gather stream stats {st}")
    figs = consumer_figures("R", stats["raw_bytes"], calls, card)
    figs.update(ratio=stats["ratio"], wire_bytes=stats["wire_bytes"],
                stream_overlap_efficiency=st["overlap_efficiency"],
                cpu_comparison_s=cpu_s)
    print(f"phase R: {N_RANKS} ranks of {nyx[0].shape} in one batched pass "
          f"pair, payloads == the card's compress (rank 0 == the CPU's), "
          f"decode == stream read (rank 0 == the CPU's bytes), ragged set "
          f"per-rank last pass, sync "
          f"stream records == overlapped: True (cpu runs {cpu_s:.2f} s) "
          f"ratio {stats['ratio']} launches={counts}")
    return counts, inputs, figs


def run_snapshot_stream_phase(mean, dispatch, census, captured, card, tmp):
    """Phase Q.stream: Q's pod-mean gradient tree through
    snapshot_grads_to_stream and restore_grad_snapshot_stream on the
    card; SNAP_LEAVES' records and bytes against the CPU run."""
    import numpy as np
    from repro_torch.core.dualquant import value_range
    from repro_torch.io import engine as E
    from repro_torch.optim import grad_compress as GC
    path = os.path.join(tmp, "grads.ceazs")

    def run():
        st, w_s = synced(lambda: GC.snapshot_grads_to_stream(path, mean))
        back, r_s = synced(lambda: GC.restore_grad_snapshot_stream(path))
        return st, back, dict(write=w_s, restore=r_s)
    (st, back, calls), counts, inputs = counted_run(
        "Q.stream", run, dispatch, census, captured)
    check_decoded_on_card("Q.stream", counts)
    host = {k: v.cpu().numpy() for k, v in mean.items()}
    path_c = os.path.join(tmp, "grads_cpu.ceazs")
    t0 = time.perf_counter()
    GC.snapshot_grads_to_stream(path_c, {k: host[k] for k in SNAP_LEAVES},
                                device="cpu")
    back_c = GC.restore_grad_snapshot_stream(path_c, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(same_records(path, path_c, SNAP_LEAVES),
          "phase Q.stream: SNAP_LEAVES' records differ from the CPU run's")
    for k in SNAP_LEAVES:
        check(back[k].tobytes() == back_c[k].tobytes(),
              f"phase Q.stream: {k} restores to other bytes than the CPU's")
    with E.StreamReader(path) as r:
        codecs = {rec["key"]: rec["codec"] for rec in r.records}
    check(sorted(back) == sorted(host) == sorted(codecs),
          "phase Q.stream: the restored keys differ from the tree's")
    n_lossy = 0
    for k, x in host.items():
        if codecs[k] == "ceaz":
            n_lossy += 1
            err = float(np.abs(back[k].astype(np.float64) - x).max())
            check(err <= 1e-3 * value_range(x),
                  f"phase Q.stream: {k} error {err} over its bound")
        else:
            check(back[k].tobytes() == x.tobytes(),
                  f"phase Q.stream: raw leaf {k} changed")
    raw = sum(x.nbytes for x in host.values())
    figs = consumer_figures("Q.stream", raw, calls, card)
    figs.update(ratio=st["raw_bytes"] / st["stored_bytes"],
                overlap_efficiency=st["overlap_efficiency"],
                cpu_comparison_s=cpu_s)
    print(f"phase Q.stream: {len(host)} leaves ({n_lossy} lossy, "
          f"{sum(x.size for x in host.values())} values), SNAP_LEAVES' "
          f"records+bytes == cpu run, lossy leaves within 1e-3 x range, raw "
          f"leaves bit-exact: True (cpu runs {cpu_s:.2f} s) "
          f"launches={counts}")
    return counts, inputs, figs


def bf16_on_card(arr):
    """A restored host leaf as the card's bf16 cast (ints as they are)."""
    import torch
    t = torch.from_numpy(arr).cuda()
    return t.to(torch.bfloat16) if t.is_floating_point() else t


def run_checkpoint_phase(dispatch, census, captured, card, tmp, seed):
    """Phase K: Q's parameter tree (and a second one from seed + 1)
    through save_checkpoint (step 1 synchronous, step 2 in the
    background) and restore_checkpoint (plan=None; a one-device mesh on
    cuda:0 with a bf16 leaf_transform) on the card. Returns the phase's
    results and the two steps' full restores for V."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.core.dualquant import value_range
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import make_plan
    d = os.path.join(tmp, "ckpt")
    params = {1: _q_state("cuda", seed), 2: _q_state("cuda", seed + 1)}
    plan = make_plan(make_mesh((1, 1), ("data", "model")))
    seen = []

    def cast(key, arr):
        seen.append(isinstance(arr, np.ndarray))
        t = torch.from_numpy(arr)
        return t.to(torch.bfloat16) if t.is_floating_point() else t

    def run():
        _, s1 = synced(lambda: C.save_checkpoint(d, params[1], 1))
        _, s2 = synced(lambda: (C.save_checkpoint(d, params[2], 2,
                                                  background=True),
                                C.wait_for_pending()))
        (full2, meta), r_s = synced(lambda: C.restore_checkpoint(d))
        (placed, _), p_s = synced(lambda: C.restore_checkpoint(
            d, plan=plan, leaf_transform=cast))
        full1, _ = C.restore_checkpoint(d, step=1)
        return full1, full2, meta, placed, dict(
            save=s1, save_background=s2, restore=r_s, restore_mesh_bf16=p_s)
    (full1, full2, meta, placed, calls), counts, inputs = counted_run(
        "K", run, dispatch, census, captured)
    check_decoded_on_card("K", counts)
    check(meta == {"step": 2}, f"phase K: restored {meta}, want step 2")
    check(sorted(os.listdir(d)) == [C.LATEST, "step_00000001",
                                    "step_00000002"],
          f"phase K: directory holds {sorted(os.listdir(d))}")
    flat = {k: dict(C.tree_items(f)) for k, f in ((1, full1), (2, full2))}
    host = {s: {k: v.cpu().numpy() for k, v in p.items()}
            for s, p in params.items()}
    n_lossy = 0
    for s in (1, 2):
        check(sorted(flat[s]) == sorted(host[s]),
              f"phase K: step {s} restores other keys")
        for k, x in host[s].items():
            y = flat[s][k]
            check(isinstance(y, np.ndarray) and y.dtype == x.dtype
                  and y.shape == x.shape, f"phase K: step {s} leaf {k}")
            if x.size >= C.CheckpointConfig.min_compress:
                n_lossy += s == 1
                err = float(np.abs(y.astype(np.float64) - x).max())
                check(err <= 5e-4 * value_range(x),
                      f"phase K: step {s} {k} error {err} over its bound")
            else:
                check(y.tobytes() == x.tobytes(),
                      f"phase K: raw leaf {k} changed")
    pf = dict(C.tree_items(placed))
    check(seen and all(seen), "phase K: leaf_transform saw a leaf that "
          "was not a host array")
    dev0 = plan.mesh.device_set[0]
    for k, y in flat[2].items():
        t, want = pf[k], bf16_on_card(y)
        check(t.device == dev0 == want.device and torch.equal(t, want),
              f"phase K: the mesh restore's {k} is not the bf16 cast on "
              f"{dev0}")
    d_raw = os.path.join(tmp, "ckpt_raw")
    raw_cfg = C.CheckpointConfig(mode="raw")
    C.save_checkpoint(d_raw, params[1], 1, cfg=raw_cfg)
    raw = dict(C.tree_items(C.restore_checkpoint(d_raw, cfg=raw_cfg)[0]))
    check(all(raw[k].tobytes() == x.tobytes() for k, x in host[1].items()),
          "phase K: mode='raw' is not bit-exact")
    # layer 0 saved on the CPU: the same records
    layer0 = {k: x for k, x in host[1].items() if k.startswith("layers/0/")}
    d_cpu = os.path.join(tmp, "ckpt_cpu")
    t0 = time.perf_counter()
    C.save_checkpoint(d_cpu, layer0, 1, device="cpu")
    cpu_s = time.perf_counter() - t0
    stream = lambda dd, s: os.path.join(dd, f"step_{s:08d}", C.LEAVES_STREAM)
    check(same_records(stream(d_cpu, 1), stream(d, 1)),
          "phase K: layer 0's records differ from a device='cpu' save's")
    raw_bytes = sum(x.nbytes for x in host[1].values())
    figs = consumer_figures("K", raw_bytes, calls, card)
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        stored = sum(v["nbytes"] for v in json.load(f)["leaves"].values())
    figs.update(ratio=raw_bytes / stored, cpu_comparison_s=cpu_s)
    print(f"phase K: {len(host[1])} leaves ({n_lossy} lossy, "
          f"{raw_bytes} B), steps 1 (sync) and 2 (background) restore "
          f"within 5e-4 x range, raw leaves and mode='raw' bit-exact, mesh "
          f"restore == bf16 cast on {dev0}, layer 0 records == cpu save: "
          f"True (cpu save {cpu_s:.2f} s) launches={counts}")
    return counts, inputs, figs, (d, stream, flat)


def run_pager_phase(ckpt, dispatch, census, captured, card, seed):
    """Phase V: a PagedParamStore over K's step-1 stream on the card (bf16,
    a budget of one layer's decoded bytes): PAGER_GETS seeded gets, each
    leaf the full restore's bf16 cast bit for bit, the budget held after
    every get and the counters consistent; then a swap to step 2 while a
    pin on the first generation is held."""
    import numpy as np
    import torch
    from repro_torch.obs import metrics as om
    from repro_torch.serve import PagedParamStore
    d, stream, flat = ckpt
    layer0 = [k for k in flat[1] if k.startswith("layers/0/")]
    budget = 2 * sum(flat[1][k].size for k in layer0)
    keys = sorted(flat[1])
    picks = [keys[i] for i in np.random.default_rng(seed).integers(
        0, len(keys), PAGER_GETS)]
    want = {s: {} for s in (1, 2)}

    def ref(s, k):
        if k not in want[s]:
            want[s][k] = bf16_on_card(flat[s][k])
        return want[s][k]
    c0 = {n: om.counter(n).value() for n in (om.PAGE_HITS, om.PAGE_MISSES,
                                             om.PAGE_EVICTIONS)}

    def run():
        store = PagedParamStore(stream(d, 1), cache_bytes=budget)
        miss_ms, hit_ms = [], []
        with store.pin() as pin:
            for k in picks:
                h = om.counter(om.PAGE_HITS).value()
                leaf, s = synced(lambda: pin.get(k))
                if om.counter(om.PAGE_HITS).value() > h:
                    hit_ms.append(s * 1e3)
                else:
                    miss_ms.append((k, s * 1e3))
                check(store.cache_resident_bytes <= budget,
                      f"phase V: {store.cache_resident_bytes} resident "
                      f"bytes over the budget {budget}")
                want1 = ref(1, k)
                check(leaf.device == want1.device
                      and torch.equal(leaf, want1),
                      f"phase V: paged {k} differs from the full restore's "
                      "bf16 cast")
        got = {n: om.counter(n).value() - v for n, v in c0.items()}
        check(got[om.PAGE_HITS] + got[om.PAGE_MISSES] == PAGER_GETS
              and len(store._cache) == got[om.PAGE_MISSES]
              - got[om.PAGE_EVICTIONS]
              and om.gauge(om.PAGE_CACHE_BYTES).value()
              == store.cache_resident_bytes,
              f"phase V: counters {got}, {len(store._cache)} entries, "
              f"gauge {om.gauge(om.PAGE_CACHE_BYTES).value()} vs "
              f"{store.cache_resident_bytes} resident")
        codec = {r["key"]: r["codec"] for r in store._gen.reader.records}
        old = store.pin()
        _, swap_s = synced(lambda: store.swap(stream(d, 2)))
        check(store.n_generations == 2 and old.generation == 0
              and store.generation == 1, "phase V: generations after swap")
        for k in SNAP_LEAVES:
            check(torch.equal(old.get(k), ref(1, k)),
                  f"phase V: the pin on generation 1 reads {k} from "
                  "another stream")
        with store.pin() as new:
            for k in SNAP_LEAVES:
                check(torch.equal(new.get(k), ref(2, k)),
                      f"phase V: a new pin reads {k} from another stream")
        old.release()
        check(store.n_generations == 1, "phase V: the old generation "
              "outlived its last pin")
        store.close()
        return got, miss_ms, hit_ms, swap_s, codec
    (got, miss_ms, hit_ms, swap_s, codec), counts, inputs = counted_run(
        "V", run, dispatch, census, captured)
    check_decoded_on_card("V", counts, encode=False)
    # page-ins of compressed leaves and of raw (npy) ones apart
    lossy_ms = [ms for k, ms in miss_ms if codec[k] == "ceaz"]
    raw_ms = [ms for k, ms in miss_ms if codec[k] != "ceaz"]
    check(lossy_ms and hit_ms, f"phase V: {len(lossy_ms)} page-ins of "
          f"compressed leaves and {len(hit_ms)} cache hits; both must occur")
    med = lambda v: statistics.median(v) if v else None
    figs = dict(page_in_ms_median=med(lossy_ms), page_in_ms=lossy_ms,
                raw_page_in_ms_median=med(raw_ms),
                hit_ms_median=med(hit_ms), hits=got[om.PAGE_HITS],
                misses=got[om.PAGE_MISSES],
                evictions=got[om.PAGE_EVICTIONS], budget_bytes=budget,
                swap_s=swap_s)
    print(f"consumer phase V [{card}]: first-touch page-in of a compressed "
          f"leaf median {figs['page_in_ms_median']} ms over {len(lossy_ms)} "
          f"(of a raw one {figs['raw_page_in_ms_median']} ms over "
          f"{len(raw_ms)}), cache hit median {figs['hit_ms_median']} ms "
          f"over {len(hit_ms)} hits (one get each, host clock after device "
          f"syncs); swap with warm-up {swap_s} s")
    print(f"phase V: {PAGER_GETS} gets, paged bits == full restore's bf16 "
          f"cast, resident <= {budget} B after every get, counters {got} "
          f"consistent, pin on generation 1 reads step 1 after the swap, "
          f"new pins step 2: True launches={counts}")
    return counts, inputs, figs


def run_corruption_check(ckpt):
    """K's fallback: bytes flipped in step 2's stream make the restore
    fall back to step 1 (run after V, which pages step 2)."""
    from repro_torch.checkpoint import ckpt as C
    d, stream, flat = ckpt
    path = stream(d, 2)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"corrupted")
    state, meta = C.restore_checkpoint(d)
    check(meta == {"step": 1}, f"phase K: a corrupted step 2 restored as "
          f"{meta}, want the fallback to step 1")
    restored = dict(C.tree_items(state))
    check(all(restored[k].tobytes() == v.tobytes()
              for k, v in flat[1].items()),
          "phase K: the fallback restore differs from step 1's")
    print("phase K: bytes flipped in step 2's stream -> restore fell back to "
          "step 1: True")


def run_consumer_phases(nyx, mean, dispatch, census, captured, card, tmp,
                        seed):
    """Phases R, Q.stream, K and V, each timed whole and its seconds
    printed -> (counts, inputs, figures)."""
    counts, inputs, figs, secs = {}, {}, {}, {}
    t0 = time.perf_counter()
    counts["R"], inputs["R"], figs["R"] = run_gather_codec_phase(
        nyx, dispatch, census, captured, card, tmp)
    secs["R"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts["Q.stream"], inputs["Q.stream"], figs["Q.stream"] = \
        run_snapshot_stream_phase(mean, dispatch, census, captured, card,
                                  tmp)
    secs["Q.stream"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts["K"], inputs["K"], figs["K"], ckpt = run_checkpoint_phase(
        dispatch, census, captured, card, tmp, seed)
    secs["K"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts["V"], inputs["V"], figs["V"] = run_pager_phase(
        ckpt, dispatch, census, captured, card, seed)
    secs["V"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_corruption_check(ckpt)
    secs["K"] += time.perf_counter() - t0
    for name, s in secs.items():
        figs[name]["phase_s"] = s
    print(f"consumer phases' seconds (whole phase, checks included): {secs}")
    return counts, inputs, figs


# phase SERVE: gemma3-1b at its published widths (configs/gemma3_1b.py)
SERVE_PARAMS = 999_885_952
# the requests: 264 prompt tokens and 8 greedy ones (cut from 600 + 32
# when phase SERVE.SSM came, for the whole run's time); the cut's f32
# prefill against its teacher-forced decode takes SERVE_WRAP_PROMPT
# tokens, past the 512-slot rings
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_CACHE = 4, 264, 8, 1024
SERVE_WRAP_PROMPT = 520
# the card-against-CPU cut: the first unit's first repeat (5 local layers
# and 1 global), B = 2, a 64-token prompt and 4 greedy steps
SERVE_CUT_BATCH, SERVE_CUT_PROMPT, SERVE_CUT_GEN = 2, 64, 4
# the reference's bound for decode against prefill
# (tests/test_models.py:83-85), also the CPU parity tests' bound
LOGIT_RTOL, LOGIT_ATOL = 0.06, 0.05
# the bf16 path's readings, as ratios to that bound, held to limits set
# from sound runs on an H100 (PERF.md section 6): the 26-layer prefill
# against its teacher-forced step read 1.50-1.72, the cut's bf16 card
# against the bf16 CPU 1.15-1.18; each limit is about 1.5 times the
# highest. The control, the KV cache rounded through float8 e4m3, must
# read past each limit.
BF16_LIMITS = {"prefill_vs_decode": 2.5, "card_vs_cpu": 1.75}
SERVE_CHUNK_VALUES = 1 << 20     # the checkpoint's 4 MB chunks of f32
LEAF_CHECK_VALUES = 1 << 26      # values of a leaf checked at a time
PAGED_BUDGET = 4 << 30          # holds the whole bf16 tree (2.0 GB)


def serve_config():
    from repro_torch.configs import gemma3_1b
    return gemma3_1b.get_config()


def same_bits(a, b):
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and a.device == \
        b.device and torch.equal(a.view(torch.int16), b.view(torch.int16))


def check_restored_leaves(restored, saved, manifest, eb, phase="SERVE"):
    """Every lossy leaf of the bf16 restore within its bound of the saved
    f32 one, |bf16(x^) - x| <= eb range(x) + half a bf16 ulp of bf16(x^);
    every raw leaf the bf16 cast of the saved one. -> (lossy, raw)."""
    import torch
    from repro_torch.convert import tree_items
    got = dict(tree_items(restored))
    n_lossy = n_raw = 0
    for k, x in tree_items(saved):
        y = got[k]
        check(y.dtype == torch.bfloat16 and y.shape == x.shape
              and y.device == x.device, f"phase {phase}: restored leaf {k}")
        if manifest[k]["codec"] == "ceaz":
            n_lossy += 1
            rng = float(x.max()) - float(x.min())
            # in slices: float64 temporaries of a whole 786 M-value table
            # would take ~30 GB
            xf, yf = x.reshape(-1), y.reshape(-1)
            for i in range(0, xf.numel(), LEAF_CHECK_VALUES):
                xs, ys = xf[i:i + LEAF_CHECK_VALUES], yf[i:i + LEAF_CHECK_VALUES]
                half_ulp = torch.ldexp(
                    torch.ones_like(ys, dtype=torch.float64),
                    torch.frexp(ys.float())[1] - 9)
                err = (ys.double() - xs.double()).abs()
                check(bool((err <= eb * rng + half_ulp).all()),
                      f"phase {phase}: {k} off its bound by "
                      f"{float((err - eb * rng - half_ulp).max())}")
        else:
            n_raw += 1
            check(same_bits(y, x.to(torch.bfloat16)),
                  f"phase {phase}: raw leaf {k} is not the bf16 cast")
    check(n_lossy + n_raw == len(got), f"phase {phase}: restored other leaves")
    return n_lossy, n_raw


def cut_to_first_repeat(cfg, params, repeats=1, blocks=None):
    """(cfg, params) of the first unit's first `repeats` repeats (and,
    where given, its first `blocks` blocks), the embedding, the final
    norm and a shared block's params (zamba2's ``params['shared']``), as
    views of `params`."""
    from repro_torch.convert import map_tree
    cut_cfg = cut_units(cfg, repeat=repeats, blocks=blocks)
    unit = params["units"][0]
    # a block with no params of its own (zamba2's shared block) has no
    # entry in a restored tree
    kept = [f"b{i}" for i in range(len(cut_cfg.units[0].blocks))
            if f"b{i}" in unit]
    cut = {"embed": params["embed"], "final_norm": params["final_norm"],
           "units": [map_tree(lambda _p, x: x[:repeats],
                              {b: unit[b] for b in kept})]}
    if "shared" in params:
        cut["shared"] = params["shared"]
    return cut_cfg, cut


@contextlib.contextmanager
def compute_dtype(dtype):
    """The port's models with their compute dtype (bf16 when serving) set
    to `dtype` while the block runs: the same code in f32 holds the
    logic to the bound, clear of bf16 rounding."""
    from repro_torch.models import modules as M
    old, M.COMPUTE_DTYPE = M.COMPUTE_DTYPE, dtype
    try:
        yield
    finally:
        M.COMPUTE_DTYPE = old


def logit_stats(pairs):
    """Over (got, want) logit pairs: the worst ratio to the bound, the
    largest difference and how many logits lie past the bound."""
    import torch
    ratio, diff, over, n = 0.0, 0.0, 0, 0
    for got, want in pairs:
        g, w = got.float().cpu(), want.float().cpu()
        r = (g - w).abs() / (LOGIT_ATOL + LOGIT_RTOL * w.abs())
        ratio = max(ratio, float(r.max()))
        diff = max(diff, float((g - w).abs().max()))
        over += int((r > 1).sum())
        n += r.numel()
    return dict(ratio=ratio, max_abs=diff, over=over, n=n)


def fp8_cache(cache):
    """The control's fault: the KV cache's k and v rounded through
    float8 e4m3 and back (the rest as it is)."""
    import torch
    from repro_torch.convert import map_tree
    return map_tree(lambda p, x: x.to(torch.float8_e4m3fn).to(x.dtype)
                    if p.rsplit("/", 1)[-1] in ("k", "v") else x, cache)


def serve_requests(dec, pre, params, cfg, prompt, n_gen, cache_len, dev,
                   tokens=None, step_ms=None, cache_dtype=None, fault=None,
                   saved=None):
    """Prefill `prompt`, teacher-force it through decode, then n_gen
    greedy steps (or the given `tokens`) -> (prefill logits, every decode
    step's logits, the generated tokens, the final cache). With a list
    `step_ms`, each greedy step is timed on the host clock between
    device syncs into it; `fault(cache)` is applied after every step;
    a dict `saved` gets the token and cache the last prompt token's step
    takes."""
    import torch
    from repro_torch.models import transformer as T
    B, P_LEN = prompt.shape
    pre_logits = pre(params, prompt)
    cache = T.init_cache(cfg, B, cache_len, device=dev,
                         dtype=cache_dtype or torch.bfloat16)
    steps, gen = [], []
    tok = prompt[:, 0]
    for t in range(P_LEN + n_gen):
        if saved is not None and t == P_LEN - 1:
            saved.update(tok=tok, cache=cache)
        if step_ms is not None and t >= P_LEN:
            (logits, cache), s = synced(lambda: dec(params, tok, cache))
            step_ms.append(s * 1e3)
        else:
            logits, cache = dec(params, tok, cache)
        if fault is not None:
            cache = fault(cache)
        steps.append(logits)
        if t + 1 < P_LEN:
            tok = prompt[:, t + 1]
        elif t + 1 < P_LEN + n_gen:
            tok = (logits.argmax(-1).to(torch.int32) if tokens is None
                   else tokens[t + 1 - P_LEN].to(dev))
            gen.append(tok)
    return pre_logits, steps, gen, cache


def cut_checks(cfg, full, prompt, dev):
    """On the restored weights cut to the first unit's first repeat (5
    local layers and 1 global): the prefill of the whole prompt against
    its teacher-forced decode on the card with the compute dtype f32
    (520 tokens: the 512-slot rings wrap); a 64-token prompt with 4
    greedy steps on the card against the port on the CPU, both with the
    compute dtype f32 (the CPU fed the card's tokens); the same in bf16
    on both sides, and, the control, the card's bf16 run with a float8
    KV cache against the CPU's bf16 -> (logit_stats of the first;
    {"float32", "bfloat16", "bfloat16_fp8_cache"}: logit_stats of each
    card run against its CPU run over prefill and every step; the CPU
    runs' seconds)."""
    import torch
    from repro_torch.convert import map_tree
    from repro_torch.launch import serve as S
    from repro_torch.runtime.sharding import ShardingPlan
    plan = ShardingPlan(mesh=None)
    cut_cfg, cut = cut_to_first_repeat(cfg, full)
    cast = lambda where, dt: map_tree(lambda _p, x: x.to(where, dt), cut)
    B, P_LEN = prompt.shape
    with compute_dtype(torch.float32):
        pre, steps, _, _ = serve_requests(
            S.make_decode_fn(cut_cfg, plan, B, SERVE_CACHE)[0],
            S.make_prefill_fn(cut_cfg, plan, B, P_LEN)[0],
            cast(dev, torch.float32), cut_cfg, prompt, 0, SERVE_CACHE, dev,
            cache_dtype=torch.float32)
    pre_vs_dec = logit_stats([(steps[-1], pre)])
    n = SERVE_CUT_PROMPT + SERVE_CUT_GEN
    dec = S.make_decode_fn(cut_cfg, plan, SERVE_CUT_BATCH, n)[0]
    pre = S.make_prefill_fn(cut_cfg, plan, SERVE_CUT_BATCH,
                            SERVE_CUT_PROMPT)[0]
    prompt = prompt[:SERVE_CUT_BATCH, :SERVE_CUT_PROMPT]
    f32, bf16 = torch.float32, torch.bfloat16
    cpu_s = 0.0

    def card_and_cpu(dt, **kw):
        nonlocal cpu_s
        with compute_dtype(dt):
            card = serve_requests(dec, pre, cast(dev, dt), cut_cfg, prompt,
                                  SERVE_CUT_GEN, n, dev, cache_dtype=dt)
            t0 = time.perf_counter()
            cpu = serve_requests(dec, pre, cast("cpu", dt), cut_cfg,
                                 prompt.cpu(), SERVE_CUT_GEN, n, "cpu",
                                 tokens=card[2], cache_dtype=dt)
            cpu_s += time.perf_counter() - t0
            ctrl = serve_requests(dec, pre, cast(dev, dt), cut_cfg, prompt,
                                  SERVE_CUT_GEN, n, dev, tokens=card[2],
                                  cache_dtype=dt, **kw) if kw else None
        pairs = lambda run: [(run[0], cpu[0])] + list(zip(run[1], cpu[1]))
        return logit_stats(pairs(card)), ctrl and logit_stats(pairs(ctrl))
    out = {"float32": card_and_cpu(f32)[0]}
    out["bfloat16"], out["bfloat16_fp8_cache"] = card_and_cpu(
        bf16, fault=fp8_cache)
    return pre_vs_dec, out, cpu_s


def run_serve_phase(dispatch, census, captured, card, tmp, seed, dev="cuda"):
    """Phase SERVE: gemma3-1b at its published widths (999,885,952
    parameters) from a seeded generator on the card, saved through
    save_checkpoint (the defaults: rel 5e-4, predictor 'auto', 4 MB
    chunks), restored for serving in full (bf16) and paged; four requests
    of 264 prompt tokens and 8 greedy tokens at B = 4 through the
    make_prefill_fn / make_decode_fn callables, prefill against the
    teacher-forced decode held to its bf16 limit (and its control, the
    last prompt step from a float8 cache, past it); the restored weights
    cut to 6 layers for the checks held to the bound (cut_checks). Keeps
    the arguments of every tiled decode walk and of the first
    value-direct calls of 2^20-value chunks for serve_kernel_rows."""
    import torch
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.convert import tree_items
    from repro_torch.kernels.megakernel import ops as MK
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    t_phase = time.perf_counter()
    cfg, plan, ccfg = serve_config(), ShardingPlan(mesh=None), \
        C.CheckpointConfig()
    d = os.path.join(tmp, "serve")
    B, P_LEN, N_GEN, L = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_CACHE

    def run():
        params = T.init_params(seed, cfg, device=dev)
        n = sum(v.numel() for _, v in tree_items(params))
        check(n == SERVE_PARAMS, f"phase SERVE: {n} parameters, want "
              f"{SERVE_PARAMS}")
        _, save_s = synced(lambda: C.save_checkpoint(d, params, 1))
        del params
        torch.cuda.empty_cache()
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        torch.cuda.reset_peak_memory_stats()
        restore_base = torch.cuda.memory_allocated()
        restored, restore_s = synced(
            lambda: S.restore_serving_params(d, plan, device=dev))
        check(restored is not None and restored[1] == {"step": 1},
              "phase SERVE: the full restore found no step 1")
        full = restored[0]
        out = dict(n=n, manifest=manifest, save_s=save_s,
                   restore_s=restore_s, restore_base=restore_base,
                   restore_peak=torch.cuda.max_memory_allocated(), full=full)
        saved = T.init_params(seed, cfg, device=dev)      # the same draws
        out["lossy"], out["raw"] = check_restored_leaves(full, saved,
                                                         manifest, ccfg.eb)
        del saved
        torch.cuda.empty_cache()
        # paged: the reference prints and returns None on any failure
        opened = S.restore_serving_params(d, plan, paged=True, device=dev,
                                          cache_bytes=PAGED_BUDGET)
        check(opened is not None, "phase SERVE: the paged restore returned "
              "None")
        store, _ = opened
        flat = dict(tree_items(full))
        unit0 = sorted(k for k in flat if k.startswith("units/0/"))
        with store, store.pin() as pin:
            emb, out["emb_first_s"] = synced(lambda: pin.get("embed/table"))
            got, out["unit0_first_s"] = synced(lambda: pin.get_many(unit0))
            _, out["emb_hit_s"] = synced(lambda: pin.get("embed/table"))
            _, out["unit0_hit_s"] = synced(lambda: pin.get_many(unit0))
            got["embed/table"] = emb
            check(all(same_bits(got[k], flat[k]) for k in got),
                  "phase SERVE: paged leaves of unit 0 or embed/table differ "
                  "from the full restore's")
            paged, out["page_all_s"] = synced(pin.params)
        del got, emb
        check(all(same_bits(v, flat[k]) for k, v in tree_items(paged)),
              "phase SERVE: the paged tree differs from the full restore")
        dec, _, _, _ = S.make_decode_fn(cfg, plan, B, L)
        pre, _, _ = S.make_prefill_fn(cfg, plan, B, P_LEN)
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        long = torch.randint(0, cfg.vocab_size, (B, SERVE_WRAP_PROMPT),
                             generator=gen, device=dev, dtype=torch.int32)
        prompt = long[:, :P_LEN]
        c0 = T.init_cache(cfg, B, L, device=dev)
        lf, _ = dec(full, prompt[:, 0], c0)
        lp, _ = dec(paged, prompt[:, 0], c0)
        check(same_bits(lf, lp), "phase SERVE: a decode step from the paged "
              "tree differs from the full tree's")
        del paged, lf, lp
        torch.cuda.empty_cache()
        # the four requests, served in bf16
        torch.cuda.reset_peak_memory_stats()
        out["serve_base"] = torch.cuda.memory_allocated()
        pre(full, prompt)                                   # warm-up
        out["pre_s"] = [synced(lambda: pre(full, prompt))[1]
                        for _ in range(3)]
        out["step_ms"], out["saved"] = [], {}
        (out["pre16"], out["steps16"], _, out["cache"]), out["serve_s"] = \
            synced(lambda: serve_requests(dec, pre, full, cfg, prompt, N_GEN,
                                          L, dev, step_ms=out["step_ms"],
                                          saved=out["saved"]))
        out["serve_peak"] = torch.cuda.max_memory_allocated()
        out["prompt"], out["dec"] = long, dec
        return out

    def first_at_chunk(op):
        return lambda a: (a[0].shape[1] == SERVE_CHUNK_VALUES
                          and op + ".kept" not in captured)
    KEEP_CALLS.update({
        "ceaz_chunk_dec": lambda a: a[1].shape[1] * a[10] > MK.DEC_FUSE_LIMIT,
        "value_quant": first_at_chunk("value_quant"),
        "value_finalize": first_at_chunk("value_finalize")})
    try:
        r, counts, inputs = counted_run("SERVE", run, dispatch, census,
                                        captured)
    finally:
        KEEP_CALLS.clear()
    check_decoded_on_card("SERVE", counts)
    kept = inputs.get("ceaz_chunk_dec.kept", [])
    check(0 < len(kept) == counts.get("hufdec_tiles", 0)
          and "value_quant.kept" in inputs and "value_finalize.kept" in inputs,
          "phase SERVE: the tiled walks' or the 2^20-value chunks' "
          "value-direct inputs were not kept")
    steps16 = r["steps16"]
    check(all(bool(torch.isfinite(x).all()) for x in steps16)
          and bool(torch.isfinite(r["pre16"]).all()),
          "phase SERVE: non-finite logits")
    check(r["cache"]["pos"].tolist() == [P_LEN + N_GEN] * B,
          f"phase SERVE: pos {r['cache']['pos'].tolist()}, want "
          f"{P_LEN + N_GEN}")
    pre_vs_dec = logit_stats([(steps16[P_LEN - 1], r["pre16"])])
    # the control: the last prompt token's step again, from its cache
    # as it was (the same logits bits) and rounded through float8
    tok, c = r["saved"]["tok"], r["saved"]["cache"]
    check(same_bits(r["dec"](r["full"], tok, c)[0], steps16[P_LEN - 1]),
          "phase SERVE: the last prompt step again from its cache differs")
    pre_vs_dec_fp8 = logit_stats([(r["dec"](r["full"], tok, fp8_cache(c))[0],
                                   r["pre16"])])
    del r["saved"], c
    t0 = time.perf_counter()
    cut_pre_vs_dec, cut, cpu_s = cut_checks(cfg, r["full"], r["prompt"], dev)
    cut_s = time.perf_counter() - t0
    check(cut_pre_vs_dec["ratio"] <= 1.0, f"phase SERVE: f32 prefill "
          f"against the teacher-forced step on the 6-layer cut: "
          f"{cut_pre_vs_dec} (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL})")
    check(cut["float32"]["ratio"] <= 1.0, f"phase SERVE: the card against "
          f"the CPU on the 6-layer cut in f32: {cut['float32']}")
    for what, got, ctrl in (
            ("prefill_vs_decode", pre_vs_dec, pre_vs_dec_fp8),
            ("card_vs_cpu", cut["bfloat16"], cut["bfloat16_fp8_cache"])):
        lim = BF16_LIMITS[what]
        check(got["ratio"] <= lim, f"phase SERVE: bf16 {what} reads "
              f"{got['ratio']} of the bound, over its limit {lim}: {got}")
        check(ctrl["ratio"] > lim, f"phase SERVE: the control (a float8 KV "
              f"cache) of bf16 {what} reads {ctrl['ratio']} of the bound, "
              f"within the limit {lim}: the limit would not see it")
    raw, stored = 4 * r["n"], sum(v["nbytes"]
                                  for v in r["manifest"].values())
    ms = statistics.median(r["step_ms"])
    figs = dict(
        params=r["n"], raw_bytes=raw, stored_bytes=stored,
        ratio=raw / stored, save_s=r["save_s"],
        save_GBps=raw / 1e9 / r["save_s"], restore_s=r["restore_s"],
        restore_GBps=raw / 1e9 / r["restore_s"],
        restore_base_bytes=r["restore_base"],
        restore_peak_bytes=r["restore_peak"], lossy_leaves=r["lossy"],
        raw_leaves=r["raw"],
        paged_embed_first_touch_ms=r["emb_first_s"] * 1e3,
        paged_unit0_first_touch_ms=r["unit0_first_s"] * 1e3,
        paged_embed_hit_ms=r["emb_hit_s"] * 1e3,
        paged_unit0_hit_ms=r["unit0_hit_s"] * 1e3,
        paged_all_s=r["page_all_s"],
        prefill_ms=statistics.median(r["pre_s"]) * 1e3,
        prefill_ms_all=[x * 1e3 for x in r["pre_s"]],
        requests_s=r["serve_s"], decode_ms_per_step=ms,
        decode_ms_all=r["step_ms"], tokens_per_s=B * 1e3 / ms,
        serve_base_bytes=r["serve_base"], serve_peak_bytes=r["serve_peak"],
        tree_bytes=2 * r["n"], prefill_vs_decode_bf16=pre_vs_dec,
        prefill_vs_decode_bf16_fp8_cache=pre_vs_dec_fp8,
        bf16_limits=BF16_LIMITS,
        cut_prefill_vs_decode_f32=cut_pre_vs_dec, cut_card_vs_cpu=cut,
        cut_checks_s=cut_s, cpu_comparison_s=cpu_s)
    figs["phase_s"] = time.perf_counter() - t_phase
    print(f"serve phase SERVE [{card}]: gemma3-1b, {r['n']} parameters "
          f"({r['lossy']} lossy leaves, {r['raw']} raw): save "
          f"{figs['save_s']} s ({figs['save_GBps']} GB/s of raw f32), ratio "
          f"{figs['ratio']}; full restore (bf16) {figs['restore_s']} s "
          f"({figs['restore_GBps']} GB/s), allocated {r['restore_base']} B "
          f"before it and {r['restore_peak']} B at its peak; paged "
          f"first touch: embed/table {figs['paged_embed_first_touch_ms']} "
          f"ms, unit 0 {figs['paged_unit0_first_touch_ms']} ms; hits "
          f"{figs['paged_embed_hit_ms']} / {figs['paged_unit0_hit_ms']} ms; "
          f"every leaf {figs['paged_all_s']} s")
    print(f"serve phase SERVE [{card}]: prefill of {B} x {P_LEN} tokens "
          f"{figs['prefill_ms']} ms (median of 3: {figs['prefill_ms_all']}); "
          f"decode at B = {B} (cache {L}) {ms} ms a step (median of "
          f"{N_GEN}), {figs['tokens_per_s']} tokens/s; 4 requests of "
          f"{P_LEN} + {N_GEN} tokens, prefill and teacher-forced decode "
          f"included: {r['serve_s']} s; allocated {r['serve_base']} B before "
          f"the requests (the {2 * r['n']} B bf16 tree, and the kernel "
          f"inputs this script keeps for its kernel rows) and "
          f"{r['serve_peak']} B at their peak; host clock after device "
          f"syncs; eager, no CUDA graph")
    blocks = cfg.units[0].blocks
    local = sum(b.attn.window is not None for b in blocks)
    print(f"serve phase SERVE: logits against the bound (rtol {LOGIT_RTOL}, "
          f"atol {LOGIT_ATOL}): bf16 prefill vs the teacher-forced step at "
          f"token {P_LEN}, {cfg.n_layers} layers: {pre_vs_dec} (limit "
          f"{BF16_LIMITS['prefill_vs_decode']}; its control, the step from "
          f"a float8 cache: {pre_vs_dec_fp8}); on the {len(blocks)}-layer "
          f"cut ({local} local + {len(blocks) - local} global): the same in "
          f"f32 {cut_pre_vs_dec}; the card against the CPU (B "
          f"{SERVE_CUT_BATCH}, {SERVE_CUT_PROMPT} + {SERVE_CUT_GEN} tokens, "
          f"prefill and every step) in f32, in bf16 (limit "
          f"{BF16_LIMITS['card_vs_cpu']}) and the bf16 control with a "
          f"float8 cache on the card: {cut}")
    print(f"phase SERVE: restored leaves within eb range + half a bf16 ulp, "
          f"raw leaves bit-exact, paged == full bitwise (unit 0, "
          f"embed/table, every leaf, a decode step's logits), logits finite, "
          f"pos {P_LEN + N_GEN}, f32 prefill vs decode and f32 card vs CPU "
          f"on the cut within the bound, bf16 within their limits and "
          f"their float8 controls past them: True (cut checks {cut_s:.2f} "
          f"s, their cpu runs {cpu_s:.2f} s; phase {figs['phase_s']:.1f} s) "
          f"launches={counts}")
    return counts, inputs, figs


# phases SERVE.MOE and SERVE.ZOO: the MoE and MLA archs at their published
# widths (depth cut), and four other attention archs' full-vocabulary
# tables through save and restore
MOE_PHI, MOE_DS = "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"
# parameters of the cuts (a meta init of each cut config): phi3.5's first
# layer, deepseek's dense first layer and first MoE layer
MOE_PARAMS = {MOE_PHI: 1_431_646_208, MOE_DS: 4_834_391_040}
MOE_UNITS = {MOE_PHI: 1, MOE_DS: 2}
MOE_BATCH, MOE_PROMPT, MOE_GEN = 2, 256, 8
ZOO_ARCHS = ("gemma3-4b", "gemma-7b", "glm4-9b", "qwen2-vl-7b",
             "whisper-base")
# the first layer, with the full vocabulary and embedding (gemma3-4b's
# first repeat of 6, 1,237,386,752 parameters, until phase TRAIN came,
# cut for the run's time: its blocks are gemma3-1b's, which SERVE and
# TRAIN run at full depth)
ZOO_PARAMS = {"gemma3-4b": 765_473_792, "gemma-7b": 1_063_265_280,
              "glm4-9b": 824_717_312, "qwen2-vl-7b": 778_054_144,
              "whisper-base": 50_461_696}
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN = 2, 64, 4


def cut_units(cfg, n_units=1, repeat=1, blocks=None):
    """`cfg` with its first `n_units` units, each cut to `repeat` repeats
    and, where given, to its first `blocks` blocks."""
    import dataclasses
    return dataclasses.replace(cfg, units=tuple(
        dataclasses.replace(u, repeat=repeat, blocks=u.blocks[:blocks])
        for u in cfg.units[:n_units]))


def meta_count(cfg):
    from repro_torch.convert import tree_items
    from repro_torch.models import transformer as T
    return sum(v.numel() for _, v in tree_items(
        T.init_params(0, cfg, device="meta")))


def save_and_restore(cfg, seed, d, dev, phase, want_n):
    """Parameters drawn from `seed` on the card (f32), saved by
    save_checkpoint at its defaults and restored in full for serving
    (bf16); every restored leaf held to its bound against the same draws
    again. The save's seconds leave out the first-sight holds made in
    it (`save_holds_s`). -> dict of the counts, seconds, bytes and the
    restored tree."""
    import torch
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.convert import tree_items
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    params = T.init_params(seed, cfg, device=dev)
    n = sum(v.numel() for _, v in tree_items(params))
    check(n == want_n == meta_count(cfg),
          f"phase {phase}: {n} parameters, want {want_n}")
    held_s = SIGHT.seconds
    _, save_s = synced(lambda: C.save_checkpoint(d, params, 1))
    held_s = SIGHT.seconds - held_s
    del params
    torch.cuda.empty_cache()
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    restored, restore_s = synced(lambda: S.restore_serving_params(
        d, ShardingPlan(mesh=None), device=dev))
    check(restored is not None and restored[1] == {"step": 1},
          f"phase {phase}: the full restore found no step 1")
    out = dict(n=n, save_s=save_s - held_s, save_holds_s=held_s,
               restore_s=restore_s, restore_base=base,
               restore_peak=torch.cuda.max_memory_allocated(),
               stored=sum(v["nbytes"] for v in manifest.values()),
               full=restored[0])
    saved = T.init_params(seed, cfg, device=dev)          # the same draws
    out["lossy"], out["raw"] = check_restored_leaves(
        out["full"], saved, manifest, C.CheckpointConfig().eb, phase)
    del saved
    torch.cuda.empty_cache()
    return out


def hold_kept_walks(kept, phase, timed):
    """Every tiled decode walk a counted restore kept, bitwise against
    its plain version on the card; the first call at each new (C, NB,
    bs) goes into `timed` for the row-4 cases. -> the walks' shapes."""
    cuda, plain = walk_fns("hufdec_tiles")
    shapes = []
    for a in kept:
        d = as_dec_args("ceaz_chunk_dec", a)
        C, NB = d[1].shape
        shape = (C, NB, d[10])
        check(same_outputs(cuda(d), plain(d)),
              f"kernel hufdec_tiles disagrees with its plain version at "
              f"phase {phase}'s walk of {shape}")
        shapes.append(shape)
        timed.setdefault(shape, (phase, d))
    return shapes


def serve_kept_calls():
    """KEEP_CALLS for the serving phases: every decode call, the tiled
    walk's and the decode megakernel's (rows of at most DEC_FUSE_LIMIT
    values), each held after the run (hold_kept_decodes)."""
    return {"ceaz_chunk_dec": lambda a: True}


def hold_kept_decodes(kept, phase, counts, timed):
    """Every decode call a counted run kept (serve_kept_calls), bitwise
    against its plain version on the card: the tiled walks
    (hold_kept_walks) and the decode megakernel's calls. Their numbers
    must equal the run's launches of the two kernels. -> the tiled
    walks' shapes."""
    from repro_torch.kernels.megakernel import ops as MK
    tiled = lambda a: a[1].shape[1] * a[10] > MK.DEC_FUSE_LIMIT
    walks = [a for a in kept if tiled(a)]
    fused = [a for a in kept if not tiled(a)]
    check(0 < len(walks) == counts.get("hufdec_tiles", 0)
          and len(fused) == counts.get("ceaz_chunk_dec_fused", 0),
          f"phase {phase}: {len(walks)} tiled walks and {len(fused)} "
          f"megakernel decodes kept, launches {counts}")
    cuda, plain = walk_fns("ceaz_chunk_dec_fused")
    for a in fused:
        d = as_dec_args("ceaz_chunk_dec", a)
        check(same_outputs(cuda(d), plain(d)),
              f"kernel ceaz_chunk_dec_fused disagrees with its plain "
              f"version at phase {phase}'s decode of {tuple(d[1].shape)}")
    return hold_kept_walks(walks, phase, timed)


def serve_steps(dec, params, cfg, prompt, n_gen, cache_len, dev,
                cache_dtype=None, step_ms=None, saved=None):
    """The prompt teacher-forced through decode, then n_gen greedy steps
    -> (every step's logits, the final cache). A dict `saved` gets the
    cache after the prompt's last token under "cache"."""
    import torch
    from repro_torch.models import transformer as T
    B, P_LEN = prompt.shape
    cache = T.init_cache(cfg, B, cache_len, device=dev,
                         dtype=cache_dtype or torch.bfloat16)
    steps, tok = [], prompt[:, 0]
    for t in range(P_LEN + n_gen):
        if step_ms is not None and t >= P_LEN:
            (logits, cache), s = synced(lambda: dec(params, tok, cache))
            step_ms.append(s * 1e3)
        else:
            logits, cache = dec(params, tok, cache)
        if saved is not None and t == P_LEN - 1:
            saved["cache"] = cache
        steps.append(logits)
        tok = prompt[:, t + 1] if t + 1 < P_LEN else \
            logits.argmax(-1).to(torch.int32)
    return steps, cache


@contextlib.contextmanager
def recording(prefill=None, decode=None, routes=None):
    """The port's blocks and MoE routing, recording while the block runs:
    each prefill block's (input, output) into `prefill`, each decode
    block's input into `decode`, each routing's (gates, result) into
    `routes` (None: not recorded)."""
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as T
    old = T._block_apply, T._block_decode, M.moe_route

    def block_apply(bp, b, h, *a, **kw):
        out = old[0](bp, b, h, *a, **kw)
        prefill.append((h, out[0]))
        return out

    def block_decode(bp, b, h, *a, **kw):
        decode.append(h)
        return old[1](bp, b, h, *a, **kw)

    def route(gates, *a):
        r = old[2](gates, *a)
        routes.append((gates, r))
        return r
    if prefill is not None:
        T._block_apply = block_apply
    if decode is not None:
        T._block_decode = block_decode
    if routes is not None:
        M.moe_route = route
    try:
        yield
    finally:
        T._block_apply, T._block_decode, M.moe_route = old


def mem_available():
    """/proc/meminfo's MemAvailable, bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def peak_rss():
    """This process's peak resident set so far, bytes."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def layer_holds(cfg, params, prompt, n_gen, dev, dtype, what,
                phase="SERVE.MOE"):
    """The model on `params` (on the card) with the compute dtype `dtype`,
    on the card and, layer by layer, on the CPU: the card's prefill and
    its teacher-forced decode of the prompt plus n_gen greedy steps are
    recorded block by block; then for each layer its weights alone come
    to the host, where it runs on the card's inputs (a shared block's
    are ``params['shared']``). Holds (as ratios to the bound,
    logit_stats): each prefill layer's output; the routing of each MoE
    layer given the card's gates, bitwise; each attention or MLA
    layer's cache slots against the CPU's prefill of that layer's
    recorded decode inputs; each SSM layer's cache after the prompt
    (mamba's conv and state; rwkv's sx, sx_cmix and state) against the
    CPU's own teacher-forced decode of that layer's recorded prompt
    inputs (an SSM prefill emits no cache); the logits from the card's
    last hidden state. -> dict of the readings, the CPU seconds and the
    prefill's dropped pairs."""
    import torch
    from repro_torch.convert import map_tree, tree_items
    from repro_torch.launch import serve as S
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    plan = ShardingPlan(mesh=None)
    B, P_LEN = prompt.shape
    N = P_LEN + n_gen
    layers = [(ui, r, bi, b) for ui, unit in enumerate(cfg.units)
              for r in range(unit.repeat) for bi, b in enumerate(unit.blocks)]
    card = map_tree(lambda _p, x: x.to(dtype), params)
    pre_rec, dec_rec, routes, after = [], [], [], {}
    with compute_dtype(dtype), recording(pre_rec, None, routes):
        pre_logits = T.serve_prefill(card, cfg, prompt, plan)
    with compute_dtype(dtype), recording(None, dec_rec, None):
        dec = S.make_decode_fn(cfg, plan, B, N)[0]
        steps, cache = serve_steps(dec, card, cfg, prompt, n_gen, N, dev,
                                   cache_dtype=dtype, saved=after)
    del card
    torch.cuda.empty_cache()
    check(len(pre_rec) == len(layers) and len(dec_rec) == len(layers) * N,
          f"phase {phase}: {what}: recorded {len(pre_rec)} prefill and "
          f"{len(dec_rec)} decode blocks")
    out = dict(layers=[], routing=[], caches=[], dropped=0,
               mem_available=mem_available())
    t0 = time.perf_counter()
    pos = torch.arange(P_LEN)[None, :]
    aux0 = torch.zeros((), dtype=torch.float32)
    moe_i = 0
    for i, (ui, r, bi, b) in enumerate(layers):
        bp_card = params["shared"] if b.use_shared else \
            T._index(params["units"][ui], r)[f"b{bi}"]
        layer_bytes = sum(x.numel() for _, x in tree_items(bp_card)) \
            * torch.finfo(dtype).bits // 8
        free = mem_available()
        check(free > layer_bytes, f"phase {phase}: {what}: layer {i}'s "
              f"{layer_bytes} B of weights do not fit the host's "
              f"MemAvailable {free} B")
        h_in, h_out = pre_rec[i]
        cpu_routes = []
        bp = map_tree(lambda _p, x: x.to("cpu", dtype), bp_card)
        with compute_dtype(dtype), recording(routes=cpu_routes):
            y, _ = T._block_apply(bp, b, h_in.cpu(), pos, plan, aux0, None)
        own = cpu_routes[0][1] if cpu_routes else None
        out["layers"].append(dict(layer=i, kind=b.kind, mlp=b.mlp_kind,
                                  host_bytes=layer_bytes,
                                  mem_available=free,
                                  **logit_stats([(y, h_out)])))
        if b.mlp_kind == "moe":
            gates, rc = routes[moe_i]
            moe_i += 1
            cap = M._moe_capacity(B * P_LEN, b.moe, b.moe.n_experts)
            rcpu = M.moe_route(gates.cpu(), b.moe.top_k, 0,
                               b.moe.n_experts, cap)
            same = {k: bool(torch.equal(rcpu[k], v.cpu()))
                    for k, v in rc.items()}
            check(all(same.values()), f"phase {phase}: {what}: layer {i}'s "
                  f"routing on the CPU given the card's gates differs: {same}")
            dropped = int((~rc["valid"]).sum())
            out["dropped"] += dropped
            out["routing"].append(dict(
                layer=i, pairs=int(rc["valid"].numel()), dropped=dropped,
                capacity=cap, tokens_routed_differently_by_cpu_gates=int(
                    (own["top_i"] != rc["top_i"].cpu()).any(-1).sum())))
        hd = torch.cat(dec_rec[i::len(layers)], 1).cpu()      # (B, N, d)
        if b.kind in ("mamba", "rwkv"):
            c = T._block_cache_init(b, B, N, cfg, dtype, "cpu")
            with compute_dtype(dtype):
                for t in range(P_LEN):
                    _, c = T._block_decode(
                        bp, b, hd[:, t:t + 1],
                        torch.full((B,), t, dtype=torch.int32), c, plan)
            cc = T._index(after["cache"]["units"][ui], r)[f"b{bi}"]
            names = tuple(sorted(c))
            out["caches"].append(dict(layer=i, leaves=names, **logit_stats(
                [(cc[n], c[n]) for n in names])))
        else:
            with compute_dtype(dtype):
                x = M.norm_apply(bp["ln1"], hd)
                npos = torch.arange(N)[None, :]
                if b.kind == "mla":
                    _, (c1, c2) = M.mla_apply(bp, b.mla, x, npos, plan)
                    names = ("c_kv", "k_rope")
                else:
                    _, (c1, c2) = M.attn_apply(bp, b.attn, x, npos, plan)
                    names = ("k", "v")
            cc = T._index(cache["units"][ui], r)[f"b{bi}"]
            out["caches"].append(dict(layer=i, leaves=names, **logit_stats(
                [(cc[names[0]][:, :N], c1), (cc[names[1]][:, :N], c2)])))
        del bp, y, hd
    host = lambda x: x.to("cpu", dtype)
    with compute_dtype(dtype):
        h = M.norm_apply(map_tree(lambda _p, x: host(x),
                                  params["final_norm"]),
                         pre_rec[-1][1][:, -1:].cpu())
        logits = M.unembed_logits({"embed": {"table": host(
            params["embed"]["table"])}}, h, plan, cfg.final_softcap)[:, 0]
    out["logits"] = logit_stats([(pre_logits, logits)])
    out["cpu_s"] = time.perf_counter() - t0
    out["host_peak_rss"] = peak_rss()
    out["finite"] = bool(torch.isfinite(pre_logits).all()) and all(
        bool(torch.isfinite(s).all()) for s in steps)
    out["pos"] = cache["pos"].tolist()
    out["worst"] = max([r["ratio"] for r in out["layers"] + out["caches"]]
                       + [out["logits"]["ratio"]])
    return out


def serve_figures(cfg, params, prompt, n_gen, dev, phase, what):
    """The bf16 path that serves: make_prefill_fn's prefill (median of
    3; a vision or audio arch with its frontend's seeded embeddings)
    with the dropped pairs of its MoE routing counted, the prompt
    teacher-forced through make_decode_fn's step and n_gen greedy steps
    (each timed), device memory at the peak. -> figures."""
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.runtime.sharding import ShardingPlan
    plan = ShardingPlan(mesh=None)
    B, P_LEN = prompt.shape
    N = P_LEN + n_gen
    fe = {}
    if cfg.frontend is not None:
        frames = cfg.frontend_len if cfg.frontend == "vision" else \
            cfg.encoder.n_frames
        gen = torch.Generator(device=dev).manual_seed(P_LEN)
        fe["frontend"] = torch.randn((B, frames, cfg.d_model), generator=gen,
                                     device=dev)
    pre = S.make_prefill_fn(
        cfg, plan, B, P_LEN + (cfg.frontend_len if cfg.frontend == "vision"
                               else 0))[0]
    dec = S.make_decode_fn(cfg, plan, B, N)[0]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    routes = []
    with recording(routes=routes):
        pre_logits = pre(params, prompt, **fe)
    dropped = sum(int((~r["valid"]).sum()) for _, r in routes)
    pairs = sum(int(r["valid"].numel()) for _, r in routes)
    del routes
    pre_s = [synced(lambda: pre(params, prompt, **fe))[1] for _ in range(3)]
    step_ms = []
    (steps, cache), serve_s = synced(lambda: serve_steps(
        dec, params, cfg, prompt, n_gen, N, dev, step_ms=step_ms))
    check(bool(torch.isfinite(pre_logits).all())
          and all(bool(torch.isfinite(s).all()) for s in steps),
          f"phase {phase}: {what}: non-finite bf16 logits")
    check(cache["pos"].tolist() == [N] * B,
          f"phase {phase}: {what}: pos {cache['pos'].tolist()}, want {N}")
    ms = statistics.median(step_ms)
    return dict(prefill_ms=statistics.median(pre_s) * 1e3,
                prefill_ms_all=[s * 1e3 for s in pre_s],
                prefill_pairs=pairs, prefill_dropped_pairs=dropped,
                requests_s=serve_s, decode_ms_per_step=ms,
                decode_ms_all=step_ms, tokens_per_s=B * 1e3 / ms,
                serve_base_bytes=base,
                serve_peak_bytes=torch.cuda.max_memory_allocated())


def run_moe_phase(dispatch, census, captured, card, tmp, seed, timed,
                  dev="cuda"):
    """Phase SERVE.MOE: phi3.5-moe's first layer (32 q and 8 kv heads of
    128, 16 experts of d_ff 6400 top 2, vocab 32064; 1,431,646,208
    parameters) saved and restored as SERVE's gemma3-1b, then served in
    bf16 (prefill of 2 x 256 tokens, the prompt teacher-forced and 8
    greedy steps); deepseek-v2's dense first layer and first MoE layer
    (MLA of 128 heads, kv_lora 512; 160 experts of 1536 top 6 and 2
    shared; vocab 102400; 4,834,391,040 parameters) drawn on the card and
    cast to bf16, no save or restore, served the same way through the
    absorbed MLA cache. Each is then held layer by layer against the
    port on the CPU (layer_holds) in f32, to the bound."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.convert import map_tree, tree_items
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    figs, counts, inputs = {}, {}, {}
    for arch in (MOE_PHI, MOE_DS):
        t_arch = time.perf_counter()
        name = f"SERVE.MOE.{arch}"
        cfg = cut_units(get_arch(arch).config(), MOE_UNITS[arch])
        gen = torch.Generator(device=dev).manual_seed(seed + 11)
        prompt = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)

        def run():
            if arch == MOE_PHI:
                r = save_and_restore(cfg, seed, os.path.join(tmp, "moe"),
                                     dev, "SERVE.MOE", MOE_PARAMS[arch])
            else:
                f32 = T.init_params(seed, cfg, device=dev)
                n = sum(v.numel() for _, v in tree_items(f32))
                check(n == MOE_PARAMS[arch] == meta_count(cfg),
                      f"phase SERVE.MOE: {arch}: {n} parameters")
                r = dict(n=n, full=map_tree(
                    lambda _p, x: x.to(torch.bfloat16), f32))
                del f32
                torch.cuda.empty_cache()
            r.update(serve_figures(cfg, r["full"], prompt, MOE_GEN, dev,
                                 "SERVE.MOE", arch))
            return r

        KEEP_CALLS.update(serve_kept_calls())
        try:
            r, counts[name], inputs[name] = counted_run(
                name, run, dispatch, census, captured)
        finally:
            KEEP_CALLS.clear()
        kept = inputs[name].pop("ceaz_chunk_dec.kept", [])
        captured.clear()
        if arch == MOE_PHI:
            check_decoded_on_card(name, counts[name])
            r["walk_shapes"] = hold_kept_decodes(kept, name, counts[name],
                                                 timed)
        del kept
        full = r.pop("full")
        holds = {}
        for dt in (torch.float32,):
            holds[str(dt).replace("torch.", "")] = layer_holds(
                cfg, full, prompt, MOE_GEN, dev, dt, arch)
        del full
        torch.cuda.empty_cache()
        f32 = holds["float32"]
        check(f32["worst"] <= 1.0 and f32["finite"]
              and f32["pos"] == [MOE_PROMPT + MOE_GEN] * MOE_BATCH,
              f"phase SERVE.MOE: {arch}: the card against the CPU in f32 "
              f"past the bound (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}): "
              f"{f32}")
        r["holds"] = holds
        r["arch_s"] = time.perf_counter() - t_arch
        figs[arch] = r
        print(f"serve phase SERVE.MOE [{card}]: {arch}, {r['n']} parameters"
              + (f": save {r['save_s']} s (less {r['save_holds_s']} s of "
                 f"first-sight holds), full restore (bf16) "
                 f"{r['restore_s']} s, allocated {r['restore_base']} B "
                 f"before it and {r['restore_peak']} B at its peak, ratio "
                 f"{4 * r['n'] / r['stored']} ({r['lossy']} lossy leaves, "
                 f"{r['raw']} raw); tiled walks bitwise == plain at "
                 f"{r['walk_shapes']}" if arch == MOE_PHI else
                 ": drawn on the card, cast to bf16, no save or restore")
              + f"; bf16 prefill of {MOE_BATCH} x {MOE_PROMPT} tokens "
              f"{r['prefill_ms']} ms (median of 3: {r['prefill_ms_all']}), "
              f"{r['prefill_dropped_pairs']} of {r['prefill_pairs']} "
              f"routed pairs dropped over capacity; decode {r['decode_ms_per_step']} "
              f"ms a step (median of {MOE_GEN}: {r['decode_ms_all']}), "
              f"{r['tokens_per_s']} tokens/s; {MOE_PROMPT} + {MOE_GEN} "
              f"steps {r['requests_s']} s; allocated {r['serve_base_bytes']} "
              f"B before and {r['serve_peak_bytes']} B at the peak; "
              f"{r['arch_s']:.1f} s with the CPU holds")
        for dt, h in holds.items():
            print(f"serve phase SERVE.MOE: {arch} card against the CPU, "
                  f"compute {dt}, ratios to the bound (rtol {LOGIT_RTOL}, "
                  f"atol {LOGIT_ATOL}){' (held)' if dt == 'float32' else ' (read; no limit)'}: "
                  f"layers {[(x['layer'], x['kind'], x['mlp'], x['ratio'], x['over']) for x in h['layers']]}; "
                  f"caches {[(x['layer'], x['leaves'], x['ratio']) for x in h['caches']]}; "
                  f"logits {h['logits']}; routing given the card's gates "
                  f"bitwise: True, {h['routing']}; MemAvailable "
                  f"{h['mem_available']} B before the holds, "
                  f"{[(x['layer'], x['host_bytes'], x['mem_available']) for x in h['layers']]} "
                  f"(layer, its weights' bytes on the host, MemAvailable "
                  f"before it); the process's peak RSS {h['host_peak_rss']} "
                  f"B; cpu {h['cpu_s']:.1f} s")
    figs["phase_s"] = time.perf_counter() - t_phase
    print(f"phase SERVE.MOE: restored leaves within eb range + half a bf16 "
          f"ulp, tiled walks bitwise, every other kernel call bitwise at "
          f"the first sight of its key, bf16 logits finite, pos "
          f"{MOE_PROMPT + MOE_GEN}, routing bitwise given the card's gates, "
          f"f32 layers, caches and logits within the bound: True (phase "
          f"{figs['phase_s']:.1f} s) launches={counts}")
    return counts, inputs, figs


def run_zoo_phase(dispatch, census, captured, card, tmp, seed, timed,
                  dev="cuda"):
    """Phase SERVE.ZOO: gemma3-4b, gemma-7b, glm4-9b, qwen2-vl-7b and
    whisper-base at their published widths, depth cut to the first layer,
    each with its full vocabulary and embedding:
    saved, restored in full as bf16 (seconds and peak allocated; every
    leaf within its bound; every tiled walk bitwise), then a prefill of
    2 x 64 tokens, the prompt teacher-forced and 4 greedy steps with
    finite logits."""
    import torch
    from repro_torch.configs import get_arch
    t_phase = time.perf_counter()
    figs, counts, inputs = {}, {}, {}
    for arch in ZOO_ARCHS:
        t_arch = time.perf_counter()
        name = f"SERVE.ZOO.{arch}"
        cfg = cut_units(get_arch(arch).config(), blocks=1)
        gen = torch.Generator(device=dev).manual_seed(seed + 13)
        prompt = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, ZOO_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)

        def run():
            r = save_and_restore(cfg, seed, os.path.join(tmp, name), dev,
                                 "SERVE.ZOO", ZOO_PARAMS[arch])
            r.update(serve_figures(cfg, r["full"], prompt, ZOO_GEN, dev,
                                 "SERVE.ZOO", arch))
            del r["full"]
            return r

        KEEP_CALLS.update(serve_kept_calls())
        try:
            r, counts[name], inputs[name] = counted_run(
                name, run, dispatch, census, captured)
        finally:
            KEEP_CALLS.clear()
        kept = inputs[name].pop("ceaz_chunk_dec.kept", [])
        captured.clear()
        torch.cuda.empty_cache()
        check_decoded_on_card(name, counts[name])
        r["walk_shapes"] = hold_kept_decodes(kept, name, counts[name],
                                             timed)
        del kept
        torch.cuda.empty_cache()
        r["arch_s"] = time.perf_counter() - t_arch
        figs[arch] = r
        print(f"serve phase SERVE.ZOO [{card}]: {arch}, {r['n']} parameters "
              f"({cfg.vocab_size} x {cfg.d_model} table): save "
              f"{r['save_s']} s ({4 * r['n'] / 1e9 / r['save_s']} GB/s; "
              f"less {r['save_holds_s']} s of first-sight holds), "
              f"ratio {4 * r['n'] / r['stored']} ({r['lossy']} lossy "
              f"leaves, {r['raw']} raw); full restore (bf16) "
              f"{r['restore_s']} s ({4 * r['n'] / 1e9 / r['restore_s']} "
              f"GB/s), allocated {r['restore_base']} B before it and "
              f"{r['restore_peak']} B at its peak; tiled walks bitwise == "
              f"plain at {r['walk_shapes']}; prefill of {ZOO_BATCH} x "
              f"{ZOO_PROMPT} {r['prefill_ms']} ms, decode "
              f"{r['decode_ms_per_step']} ms a step; {r['arch_s']:.1f} s")
    figs["phase_s"] = time.perf_counter() - t_phase
    print(f"phase SERVE.ZOO: every arch saved and restored at its full "
          f"vocabulary, leaves within eb range + half a bf16 ulp, tiled "
          f"walks bitwise, every other kernel call bitwise at the first "
          f"sight of its key, logits finite, pos {ZOO_PROMPT + ZOO_GEN}: True "
          f"(phase {figs['phase_s']:.1f} s) launches={counts}")
    return counts, inputs, figs


# phase SERVE.SSM: the SSM archs at their published widths
SSM_RWKV, SSM_ZAMBA = "rwkv6-1.6b", "zamba2-7b"
# parameters: rwkv6's first 4 of its 24 layers (all 24, 1,465,501,696
# parameters, until phase TRAIN came, cut for the run's time); zamba2's
# first unit's first repeat (the shared block, 6 mamba layers, the
# embedding), and the whole model
SSM_RWKV_LAYERS = 4
SSM_PARAMS = {SSM_RWKV: 356_100_096, SSM_ZAMBA: 788_088_032}
ZAMBA_PARAMS = 6_636_442_832
# the requests: 80 prompt tokens (two mamba chunks, the second's tail
# padded; five WKV chunks) and 8 greedy ones (256 + 8 until phase TRAIN
# came, cut for the run's time)
SSM_BATCH, SSM_PROMPT, SSM_GEN = 2, 80, 8
# zamba2's whole model serves the prompt's first 32 tokens (one mamba
# chunk, padded; 80 + 8 until phase TRAIN came, cut for the run's time)
ZAMBA_SERVE_PROMPT = 32
# the CPU holds: rwkv6's first 2 layers (4 until phase TRAIN came) and
# the first 2 blocks of zamba2's restored cut (the shared block and a
# mamba layer; the whole cut until phase TRAIN came), at B = 2 with an
# 80-token prompt (two mamba chunks, the second's tail padded; five WKV
# chunks) and 2 greedy steps: the CPU decodes each SSM layer's prompt
# step by step
SSM_HOLD_LAYERS, SSM_HOLD_BLOCKS = 2, 2
SSM_HOLD_PROMPT, SSM_HOLD_GEN = 80, 2
# kernels a counted run must launch beyond PHASE_KERNELS: zamba2's small
# leaves decode in the decode megakernel, the one model path that
# launches it (held by hold_kept_decodes; these phases keep no inputs
# for the kernel rows, which take their phases from PHASE_KERNELS)
SSM_ALSO = {SSM_ZAMBA: ("ceaz_chunk_dec_fused",)}


def cache_bytes(cfg, tokens):
    """A sequence's decode cache at `tokens` positions, bytes (bf16 with
    f32 SSM states), and what a K and V cache of d_model values a token
    and layer in bf16 would take for the same layers."""
    from repro_torch.convert import tree_items
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, 1, tokens, device="meta")
    have = sum(v.numel() * v.element_size() for k, v in tree_items(cache)
               if k != "pos")
    return have, 2 * cfg.n_layers * cfg.d_model * tokens * 2


def run_ssm_phase(dispatch, census, captured, card, tmp, seed, timed,
                  dev="cuda"):
    """Phase SERVE.SSM: rwkv6-1.6b at its published widths, its first
    SSM_RWKV_LAYERS of 24 layers (d 2048, d_ff 7168, vocab 65536;
    356,100,096 parameters) drawn, saved and restored in full as bf16,
    then served (prefill of 2 x 80 tokens, the prompt teacher-forced and
    8 greedy steps: logits finite, pos 88); zamba2-7b at its published
    widths (d 3584, 112 SSM heads of 64, state 64; the shared block of 32
    heads x 112, d_ff 14336; vocab 32000): its first unit's first repeat
    (the shared block, 6 mamba layers, the embedding; 788,088,032
    parameters) saved and restored in full as bf16, then the whole model
    (81 mamba layers in units of 13 x 7 and 1 x 4 with the shared block;
    6,636,442,832 parameters) drawn on the card, cast to bf16 and served
    on the prompt's first ZAMBA_SERVE_PROMPT tokens (no save: 26.5 GB of
    f32). Each arch is a counted run of its own (SERVE.SSM.<arch>); then
    rwkv6's first SSM_HOLD_LAYERS layers and the first SSM_HOLD_BLOCKS
    blocks of zamba2's restored cut are held layer by layer against the
    port on the CPU (layer_holds) in f32, to the bound."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.convert import map_tree, tree_items
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    figs, counts, inputs = {}, {}, {}
    bf16 = torch.bfloat16
    for arch in (SSM_RWKV, SSM_ZAMBA):
        t_arch = time.perf_counter()
        name = f"SERVE.SSM.{arch}"
        full_cfg = get_arch(arch).config()
        cfg = cut_units(full_cfg, repeat=SSM_RWKV_LAYERS) \
            if arch == SSM_RWKV else cut_units(full_cfg)
        gen = torch.Generator(device=dev).manual_seed(seed + 17)
        serve_len = SSM_PROMPT if arch == SSM_RWKV else ZAMBA_SERVE_PROMPT
        prompt = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)

        def run():
            t0 = time.perf_counter()
            r = save_and_restore(cfg, seed, os.path.join(tmp, name), dev,
                                 "SERVE.SSM", SSM_PARAMS[arch])
            secs["save_and_restore"] = time.perf_counter() - t0
            if arch == SSM_ZAMBA:
                t0 = time.perf_counter()
                f32 = T.init_params(seed, full_cfg, device=dev)
                n = sum(v.numel() for _, v in tree_items(f32))
                check(n == ZAMBA_PARAMS == meta_count(full_cfg),
                      f"phase SERVE.SSM: {arch}: {n} parameters drawn")
                served = map_tree(lambda _p, x: x.to(bf16), f32)
                del f32
                torch.cuda.empty_cache()
                r["served_n"] = n
                secs["draw_and_cast"] = time.perf_counter() - t0
            else:
                served = r["full"]
            t0 = time.perf_counter()
            r.update(serve_figures(cfg if arch == SSM_RWKV else full_cfg,
                                   served, prompt[:, :serve_len], SSM_GEN,
                                   dev,
                                   "SERVE.SSM", arch))
            secs["serve"] = time.perf_counter() - t0
            del served
            return r

        secs = {}
        KEEP_CALLS.update(serve_kept_calls())
        try:
            r, counts[name], inputs[name] = counted_run(
                name, run, dispatch, census, captured,
                also=SSM_ALSO.get(arch, ()))
        finally:
            KEEP_CALLS.clear()
        kept = inputs[name].pop("ceaz_chunk_dec.kept", [])
        captured.clear()
        torch.cuda.empty_cache()
        check_decoded_on_card(name, counts[name])
        t0 = time.perf_counter()
        r["walk_shapes"] = hold_kept_decodes(kept, name, counts[name],
                                             timed)
        secs["decode_holds"] = time.perf_counter() - t0
        del kept
        full = r.pop("full")
        hold_cfg, held = cut_to_first_repeat(cfg, full, SSM_HOLD_LAYERS) \
            if arch == SSM_RWKV else \
            cut_to_first_repeat(cfg, full, blocks=SSM_HOLD_BLOCKS)
        hold_prompt = prompt[:, :SSM_HOLD_PROMPT]
        holds = {}
        for dt in (torch.float32,):
            t0 = time.perf_counter()
            holds[str(dt).replace("torch.", "")] = layer_holds(
                hold_cfg, held, hold_prompt, SSM_HOLD_GEN, dev, dt, arch,
                "SERVE.SSM")
            secs[f"holds_{dt}".replace("torch.", "")] = \
                time.perf_counter() - t0
        del full, held
        torch.cuda.empty_cache()
        f32 = holds["float32"]
        check(f32["worst"] <= 1.0 and f32["finite"] and f32["pos"] ==
              [SSM_HOLD_PROMPT + SSM_HOLD_GEN] * SSM_BATCH,
              f"phase SERVE.SSM: {arch}: the card against the CPU in f32 "
              f"past the bound (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}): "
              f"{f32}")
        r["holds"] = holds
        tokens = serve_len + SSM_GEN
        r["cache_bytes_per_seq"], r["attention_cache_bytes_per_seq"] = \
            cache_bytes(full_cfg, tokens)
        r["arch_s"] = time.perf_counter() - t_arch
        r["seconds"] = secs
        figs[arch] = r
        served = (f"{cfg.n_layers} layers as restored" if arch ==
                  SSM_RWKV else f"the whole model, {r['served_n']} "
                  f"parameters drawn on the card and cast to bf16 (no "
                  f"save), {full_cfg.n_layers} layers")
        print(f"serve phase SERVE.SSM [{card}]: {arch}, {r['n']} parameters "
              f"saved: save {r['save_s']} s ({4 * r['n'] / 1e9 / r['save_s']}"
              f" GB/s; less {r['save_holds_s']} s of first-sight holds), "
              f"ratio {4 * r['n'] / r['stored']} ({r['lossy']} lossy "
              f"leaves, {r['raw']} raw); full restore (bf16) "
              f"{r['restore_s']} s ({4 * r['n'] / 1e9 / r['restore_s']} "
              f"GB/s), allocated {r['restore_base']} B before it and "
              f"{r['restore_peak']} B at its peak; tiled walks bitwise == "
              f"plain at {r['walk_shapes']}; served {served}: bf16 prefill "
              f"of {SSM_BATCH} x {serve_len} tokens {r['prefill_ms']} ms "
              f"(median of 3: {r['prefill_ms_all']}); decode "
              f"{r['decode_ms_per_step']} ms a step (median of {SSM_GEN}: "
              f"{r['decode_ms_all']}), {r['tokens_per_s']} tokens/s; "
              f"{serve_len} + {SSM_GEN} steps {r['requests_s']} s; "
              f"allocated {r['serve_base_bytes']} B before and "
              f"{r['serve_peak_bytes']} B at the peak; decode cache "
              f"{r['cache_bytes_per_seq']} B a sequence at {tokens} "
              f"tokens, against {r['attention_cache_bytes_per_seq']} B for "
              f"a bf16 K and V cache of d_model a token and layer; "
              f"{r['arch_s']:.1f} s with the CPU holds, of which {secs}")
        for dt, h in holds.items():
            print(f"serve phase SERVE.SSM: {arch} card against the CPU "
                  f"({hold_cfg.n_layers} layers, {SSM_BATCH} x "
                  f"{SSM_HOLD_PROMPT} + {SSM_HOLD_GEN} tokens), compute {dt}"
                  f", ratios to the bound (rtol {LOGIT_RTOL}, atol "
                  f"{LOGIT_ATOL}){' (held)' if dt == 'float32' else ' (read; no limit)'}: "
                  f"layers {[(x['layer'], x['kind'], x['mlp'], x['ratio'], x['over']) for x in h['layers']]}; "
                  f"caches {[(x['layer'], x['leaves'], x['ratio']) for x in h['caches']]}; "
                  f"logits {h['logits']}; MemAvailable {h['mem_available']} "
                  f"B before the holds; the process's peak RSS "
                  f"{h['host_peak_rss']} B; cpu {h['cpu_s']:.1f} s")
    figs["phase_s"] = time.perf_counter() - t_phase
    print(f"phase SERVE.SSM: restored leaves within eb range + half a bf16 "
          f"ulp, tiled walks bitwise, every other kernel call bitwise at "
          f"the first sight of its key, bf16 logits finite, pos "
          f"{SSM_PROMPT + SSM_GEN} and {ZAMBA_SERVE_PROMPT + SSM_GEN}, f32 "
          f"layers, caches and logits within "
          f"the bound: True (phase {figs['phase_s']:.1f} s) "
          f"launches={counts}")
    return counts, inputs, figs


# -- the training path (phase TRAIN) ------------------------------------------

TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 2, 2048, 6, 3
# the card against the CPU: the first repeat (6 layers) at full width, one
# sequence of 640 tokens (past the 512 window; 2 q blocks)
TRAIN_HOLD_BATCH, TRAIN_HOLD_SEQ = 1, 640
# a bf16 rounding: the flash backward rounds p, do, v and ds to bf16
GRAD_REL = 2.0 ** -7
LOSS_RTOL = 1e-5
# the leaves decoded again on the CPU from the resumed checkpoint's
# stream (the whole stream takes ~4 min of CPU decode): the global
# layer's attention of unit 0 with its moments, the final norm, the step
TRAIN_CPU_LEAVES = ("params/units/0/b5/attn/", "opt/mu/units/0/b5/attn/",
                    "opt/nu/units/0/b5/attn/", "params/final_norm/",
                    "opt/step")


@contextlib.contextmanager
def swapped(*swaps):
    """(obj, name, value) attributes set while the block runs."""
    old = [(o, n, getattr(o, n)) for o, n, _ in swaps]
    for o, n, v in swaps:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in old:
            setattr(o, n, v)


def rel_l2(got, want):
    """||got - want|| / ||want|| in float64, on got's device."""
    a, b = got.double(), want.to(got.device).double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def host_bytes(x) -> bytes:
    """The bytes of a host leaf: a numpy array or a CPU tensor (bf16)."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).contiguous().view(torch.uint8).numpy() \
            .tobytes()
    return np.ascontiguousarray(x).tobytes()


def lm_grads(params, cfg, batch, plan):
    """(loss, {path: grad}) of lm_loss over the f32 leaves of params."""
    import torch
    from repro_torch.convert import map_tree, tree_items
    from repro_torch.models import transformer as T
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tree_items(params)}
    loss, _ = T.lm_loss(map_tree(lambda k, _v: leaves[k], params), cfg,
                        batch, plan)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), got)}


def grad_holds(cfg, params, batch, plan, dev):
    """lm_loss and its gradients of `params` on the card against the port
    on the CPU, the compute dtype f32 on both sides -> the loss's relative
    difference, the grad norms' and the worst leaf's relative L2 (each
    to hold within LOSS_RTOL, GRAD_REL, GRAD_REL), and the CPU seconds."""
    import torch
    from repro_torch.convert import map_tree
    from repro_torch.optim.adamw import global_norm
    with compute_dtype(torch.float32):
        card_loss, card = lm_grads(params, cfg, batch, plan)
        t0 = time.perf_counter()
        cpu_loss, cpu = lm_grads(map_tree(lambda _p, x: x.cpu(), params),
                                 cfg, {k: v.cpu() for k, v in batch.items()},
                                 plan)
        cpu_s = time.perf_counter() - t0
    gn_card, gn_cpu = float(global_norm(card)), float(global_norm(cpu))
    worst = max((rel_l2(card[k].cpu(), g), k) for k, g in cpu.items())
    return dict(loss=[float(card_loss), float(cpu_loss)],
                loss_rel=abs(float(card_loss) / float(cpu_loss) - 1),
                grad_norm=[gn_card, gn_cpu],
                grad_norm_rel=abs(gn_card / gn_cpu - 1),
                worst_leaf=list(worst), leaves=len(cpu), cpu_s=cpu_s)


def flash_holds(dev, seed):
    """The flash backward at gemma3-1b's attention shapes (B 2, S 2048,
    4 q heads and 1 kv head of 256, bf16; the 512 window and the global
    layer): dq, dk, dv on the card against the port on the CPU and
    against a naive f32 softmax attention under autograd on the card,
    relative L2 each; the card's forward + backward ms (host clock after
    syncs, median of 3)."""
    import torch
    from repro_torch.models import modules as M
    B, S, H, K, D = TRAIN_BATCH, TRAIN_SEQ, 4, 1, 256
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v, do = mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D), \
        mk(B, S, H, D)
    out = {}
    for window in (512, None):
        kw = dict(causal=True, window=window)

        def grads(q, k, v, do):
            t = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
            o = M.flash_attention(*t, **kw)
            return torch.autograd.grad(o, t, do)
        card = grads(q, k, v, do)
        ms = sorted(synced(lambda: grads(q, k, v, do))[1] * 1e3
                    for _ in range(3))
        t0 = time.perf_counter()
        cpu = grads(*(x.cpu() for x in (q, k, v, do)))
        cpu_s = time.perf_counter() - t0
        t = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
        s = torch.einsum("bqhd,bkhd->bhqk", t[0],
                         t[1].expand(B, S, H, D)) * D ** -0.5
        qp = torch.arange(S, device=dev)[:, None]
        kp = torch.arange(S, device=dev)[None, :]
        mask = (kp <= qp) & ((kp > qp - window) if window else True)
        s = torch.where(mask, s, torch.tensor(-1e30, device=dev))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                         t[2].expand(B, S, H, D))
        naive = torch.autograd.grad(o, t, do.float())
        del s, o
        out[str(window)] = dict(
            vs_cpu=[rel_l2(c.cpu(), g) for c, g in zip(card, cpu)],
            vs_naive=[rel_l2(c, n) for c, n in zip(card, naive)],
            card_ms=ms[1], cpu_s=cpu_s)
    return out


# phase TRAIN's depth: gemma3-1b's first repeat (6 of its 26 layers,
# 463,043,712 parameters; the whole model until phase TRAIN.DIST came,
# cut for the run's time)
TRAIN_REPEATS = 1
TRAIN_PARAMS = 463_043_712


def train_config():
    return cut_units(serve_config(), n_units=1, repeat=TRAIN_REPEATS)


def run_train_phase(dispatch, census, captured, card, tmp, seed, timed,
                    dev="cuda"):
    """Phase TRAIN: gemma3-1b at its published widths, its first
    TRAIN_REPEATS repeats (train_config) trained through
    ``launch.train.main`` on the
    card: init_state from a generator on the card, ``batch_for_step``
    data at B = 2, S = 2048 (4 q blocks and 2 kv blocks of the flash,
    the 512 window binding), 6 steps with a compressed checkpoint of the
    whole state at steps 3 and 6; then step 3's checkpoint alone resumed
    by ``main --resume`` (restored on the card) for steps 4-6 again,
    which checkpoints step 6 once more. One counted run holds both.
    Holds: every
    loss finite, step 0's in (0.5 ln V, 3 ln V), every grad norm finite
    and > 0; the resumed batches bitwise the uninterrupted ones (and
    ``batch_for_step``'s); the restored state within the checkpoint's
    rel 5e-4 of the step-3 state (raw leaves bitwise) and, for
    TRAIN_CPU_LEAVES, bitwise the CPU's decode of the same records;
    every restore walk bitwise against its plain version; the first
    repeat's loss and gradients on the card against the CPU in f32
    (grad_holds); the flash backward at the model's attention shapes
    (flash_holds). Prints the step ms, one profiled step's device ms and
    idle share, tokens/s, the peak allocated with remat 'block' and
    'none', the save and restore seconds, GB/s and ratio, and the
    phase's seconds."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.convert import dtype_name, tree_items
    from repro_torch.core.ceaz import CEAZCompressed
    from repro_torch.data.synthetic import DataConfig, batch_for_step
    from repro_torch.io import engine as E
    from repro_torch.launch import train as TR
    from repro_torch.runtime.sharding import ShardingPlan
    t_phase = time.perf_counter()
    cfg, plan = train_config(), ShardingPlan(mesh=None)
    check(meta_count(cfg) == TRAIN_PARAMS, "phase TRAIN: parameter count")
    arch = TR.get_arch(TRAIN_ARCH)
    cut_spec = lambda _a: dataclasses.replace(arch, config=train_config)
    d_full, d_res = os.path.join(tmp, "train"), \
        os.path.join(tmp, "train_resume")
    args = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--device", dev]
    dc = DataConfig(vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH,
                    seq_len=TRAIN_SEQ)
    runs = {"full": {}, "resumed": {}}
    io = {"save_s": [], "save_holds_s": [], "restore_s": []}
    keep, current, mark = {}, ["full"], [0.0]
    save, restore = C.save_checkpoint, C.restore_checkpoint

    # main makes its checkpoint calls itself: they are timed by wrapping
    # the two functions for the run, and each moves the step clock's mark
    def timed_save(*a, **kw):
        held = SIGHT.seconds
        out, s = synced(lambda: save(*a, **kw))
        held = SIGHT.seconds - held
        io["save_s"].append(s - held)
        io["save_holds_s"].append(held)
        mark[0] = time.perf_counter()
        return out

    def timed_restore(*a, **kw):
        out, s = synced(lambda: restore(*a, **kw))
        io["restore_s"].append(s)
        keep["restored"] = out
        mark[0] = time.perf_counter()
        return out

    def callback(i, state, metrics, batch):
        # the host clock after a sync since the last step or checkpoint
        # (a run's first step also takes its set-up)
        torch.cuda.synchronize()
        runs[current[0]][i] = dict(
            ms=(time.perf_counter() - mark[0]) * 1e3,
            batch={k: v.clone() for k, v in batch.items()},
            **{k: float(v) for k, v in metrics.items()})
        if current[0] == "full" and i + 1 == TRAIN_CKPT_EVERY:
            keep["state"] = state
        mark[0] = time.perf_counter()

    def run():
        with swapped((C, "save_checkpoint", timed_save),
                     (C, "restore_checkpoint", timed_restore),
                     (TR, "get_arch", cut_spec)):
            mark[0] = time.perf_counter()
            TR.main(args + ["--ckpt-dir", d_full], callback=callback)
            step3 = f"step_{TRAIN_CKPT_EVERY:08d}"
            os.makedirs(os.path.join(d_res, step3))
            for f in os.listdir(os.path.join(d_full, step3)):
                os.link(os.path.join(d_full, step3, f),
                        os.path.join(d_res, step3, f))
            current[0] = "resumed"
            mark[0] = time.perf_counter()
            return TR.main(args + ["--ckpt-dir", d_res, "--resume"],
                           callback=callback)[0]

    KEEP_CALLS.update(serve_kept_calls())
    try:
        state, counts, inputs = counted_run("TRAIN", run, dispatch, census,
                                            captured)
    finally:
        KEEP_CALLS.clear()
    secs = {"train_and_resume": time.perf_counter() - t_phase}
    kept = inputs.pop("ceaz_chunk_dec.kept", [])
    captured.clear()
    torch.cuda.empty_cache()
    check_decoded_on_card("TRAIN", counts)
    t0 = time.perf_counter()
    walk_shapes = hold_kept_decodes(kept, "TRAIN", counts, timed)
    secs["decode_holds"] = time.perf_counter() - t0
    del kept
    full, res = runs["full"], runs["resumed"]
    check(sorted(full) == list(range(TRAIN_STEPS)) and sorted(res) ==
          list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)),
          f"phase TRAIN: steps {sorted(full)} and resumed {sorted(res)}")
    ln_v = float(np.log(cfg.vocab_size))
    for name, r in runs.items():
        for i, m in r.items():
            check(all(np.isfinite(m[k]) for k in ("loss", "xent", "aux",
                                                   "grad_norm"))
                  and m["grad_norm"] > 0,
                  f"phase TRAIN: {name} step {i} metrics {m}")
    check(0.5 * ln_v < full[0]["loss"] < 3 * ln_v,
          f"phase TRAIN: step 0's loss {full[0]['loss']} outside (0.5 ln V,"
          f" 3 ln V)")
    for i, m in full.items():
        want = batch_for_step(dc, i)
        check(all(np.array_equal(m["batch"][k].cpu().numpy(), want[k])
                  for k in want), f"phase TRAIN: step {i}'s batch")
        if i in res:
            check(all(torch.equal(res[i]["batch"][k], v)
                      for k, v in m["batch"].items()),
                  f"phase TRAIN: the resumed step {i}'s batch differs")
    # the restored state against the step-3 state; CPU decodes of some
    # of its records
    t0 = time.perf_counter()
    rest, meta = keep.pop("restored")
    check(meta == {"step": TRAIN_CKPT_EVERY,
                   "data": {"step": TRAIN_CKPT_EVERY}},
          f"phase TRAIN: restored {meta}")
    step3 = os.path.join(d_res, f"step_{TRAIN_CKPT_EVERY:08d}")
    with open(os.path.join(step3, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    got = dict(tree_items(rest))
    saved = dict(tree_items(keep.pop("state")))
    check(sorted(got) == sorted(saved) == sorted(manifest),
          "phase TRAIN: the restored state has other leaves")
    eb = C.CheckpointConfig().eb
    n_lossy = 0
    for k, x in saved.items():
        y = got[k]
        y = (y if isinstance(y, torch.Tensor) else
             torch.from_numpy(np.asarray(y))).to(x.device)
        check(y.dtype == x.dtype and y.shape == x.shape,
              f"phase TRAIN: restored leaf {k}")
        if manifest[k]["codec"] == "ceaz":
            n_lossy += 1
            bound = eb * (float(x.max().double()) - float(x.min().double()))
            xf, yf = x.reshape(-1), y.reshape(-1)
            for j in range(0, xf.numel(), LEAF_CHECK_VALUES):
                err = float((yf[j:j + LEAF_CHECK_VALUES].double()
                             - xf[j:j + LEAF_CHECK_VALUES].double())
                            .abs().max())
                check(err <= bound, f"phase TRAIN: restored {k} off its "
                      f"bound {bound} by {err}")
        else:
            check(torch.equal(y.view(-1).view(torch.uint8),
                              x.reshape(-1).contiguous().view(torch.uint8)),
                  f"phase TRAIN: raw leaf {k} changed")
    del saved
    secs["restored_leaves"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    comp = C._compressor(C.CheckpointConfig(), "cpu")
    cpu_keys = [k for k in manifest if k.startswith(TRAIN_CPU_LEAVES)]
    with E.StreamReader(os.path.join(step3, C.LEAVES_STREAM)) as reader:
        for k in cpu_keys:
            obj = reader.read_key(k)
            if isinstance(obj, CEAZCompressed):
                obj = comp.decompress(obj).astype(
                    np.dtype(manifest[k]["dtype"])).reshape(got[k].shape)
            check(dtype_name(obj) == dtype_name(got[k])
                  and host_bytes(obj) == host_bytes(got[k]),
                  f"phase TRAIN: the card's restore of {k} is not the "
                  f"CPU's decode")
    secs["cpu_decode"] = time.perf_counter() - t0
    del rest, got
    # the first repeat's gradients on the card against the CPU
    hdc = DataConfig(vocab_size=cfg.vocab_size,
                     global_batch=TRAIN_HOLD_BATCH, seq_len=TRAIN_HOLD_SEQ,
                     seed=seed)
    cut_cfg, cut = cut_to_first_repeat(cfg, state["params"])
    t0 = time.perf_counter()
    holds = grad_holds(cut_cfg, cut, TR.batch_on(batch_for_step(hdc, 0),
                                                 dev), plan, dev)
    secs["grad_holds"] = time.perf_counter() - t0
    check(holds["loss_rel"] <= LOSS_RTOL and holds["grad_norm_rel"] <=
          GRAD_REL and holds["worst_leaf"][0] <= GRAD_REL,
          f"phase TRAIN: the card against the CPU past the bounds (loss "
          f"rtol {LOSS_RTOL}, gradients {GRAD_REL}): {holds}")
    t0 = time.perf_counter()
    flash = flash_holds(dev, seed)
    secs["flash_holds"] = time.perf_counter() - t0
    check(all(max(f["vs_cpu"] + f["vs_naive"]) <= GRAD_REL
              for f in flash.values()),
          f"phase TRAIN: the flash backward past {GRAD_REL}: {flash}")
    # one profiled step; the peak allocated by a step with remat 'block'
    # and with 'none', from the same state
    batch = TR.batch_on(batch_for_step(dc, TRAIN_STEPS), dev)
    tc = TR.TrainConfig()
    t0 = time.perf_counter()
    peak = {}
    for remat in ("block", "none"):
        fn = TR.make_train_step(dataclasses.replace(cfg, remat=remat), tc,
                                plan, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            if remat == "block":
                prof = device_breakdown(
                    "TRAIN step", lambda: fn(state, batch), top=8,
                    host_ops=False)
            else:
                fn(state, batch)
            peak[remat] = [base, torch.cuda.max_memory_allocated()]
        except torch.cuda.OutOfMemoryError:
            peak[remat] = [base, None]        # it did not fit
    del state, batch
    torch.cuda.empty_cache()
    secs["profile_and_peaks"] = time.perf_counter() - t0
    n = TRAIN_PARAMS
    stored = {}
    for s in (TRAIN_CKPT_EVERY, TRAIN_STEPS):
        with open(os.path.join(d_full, f"step_{s:08d}", "manifest.json")) as f:
            stored[s] = sum(v["nbytes"] for v in json.load(f)["leaves"]
                            .values())
    state_bytes = sum(v["raw_nbytes"] for v in manifest.values())
    # each run's first step also takes its set-up (init_state, or
    # restore_state's copies to the card): left out of the median
    ms = {name: [r[i]["ms"] for i in sorted(r)] for name, r in runs.items()}
    steady = ms["full"][1:] + ms["resumed"][1:]
    figs = dict(
        params=n, steps_ms=ms["full"], resumed_steps_ms=ms["resumed"],
        step_ms=statistics.median(steady),
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(steady)
        * 1e3, profile=prof, peak=peak,
        losses=[full[i]["loss"] for i in sorted(full)],
        resumed_losses=[res[i]["loss"] for i in sorted(res)],
        grad_norms=[full[i]["grad_norm"] for i in sorted(full)],
        save_s=io["save_s"], save_holds_s=io["save_holds_s"],
        restore_s=io["restore_s"], state_bytes=state_bytes,
        ratio=state_bytes / stored[TRAIN_CKPT_EVERY], stored=stored,
        lossy=n_lossy, raw=len(manifest) - n_lossy, cpu_leaves=len(cpu_keys),
        walk_shapes=walk_shapes, holds=holds, flash=flash, seconds=secs)
    figs["phase_s"] = time.perf_counter() - t_phase
    print(f"train phase TRAIN [{card}]: {TRAIN_ARCH}, {n} parameters, B "
          f"{TRAIN_BATCH} x S {TRAIN_SEQ}: steps {figs['steps_ms']} ms, "
          f"resumed {figs['resumed_steps_ms']} ms (each with its run's "
          f"set-up; median after each run's first {figs['step_ms']} ms, "
          f"{figs['tokens_per_s']} tokens/s); one "
          f"profiled step: wall {prof['wall_ms']} ms, device "
          f"{prof['device_ms']} ms, idle share {prof['idle_share']}; "
          f"allocated before a step and at its peak {peak['block']} B with "
          f"remat 'block', {peak['none']} B with 'none'; losses "
          f"{figs['losses']}, resumed "
          f"from step {TRAIN_CKPT_EVERY} {figs['resumed_losses']} (no "
          f"limit), grad norms {figs['grad_norms']}")
    gb = state_bytes / 1e9
    print(f"train phase TRAIN [{card}]: the state {state_bytes} B saved "
          f"in {io['save_s']} s ({[gb / s for s in io['save_s']]} GB/s; "
          f"less {io['save_holds_s']} s of first-sight holds), ratio "
          f"{figs['ratio']} ({n_lossy} lossy leaves, {figs['raw']} raw); "
          f"restored in {io['restore_s']} s "
          f"({[gb / s for s in io['restore_s']]} GB/s), every leaf within "
          f"rel {eb} of the step-{TRAIN_CKPT_EVERY} state, "
          f"{len(cpu_keys)} leaves bitwise the CPU's decode; tiled walks "
          f"bitwise == plain at {walk_shapes}")
    print(f"train phase TRAIN: the first repeat on the card against the "
          f"CPU in f32 (B {TRAIN_HOLD_BATCH} x S {TRAIN_HOLD_SEQ}): {holds}; "
          f"the flash backward at B {TRAIN_BATCH} x S {TRAIN_SEQ}, 4 x 1 "
          f"heads of 256 (card "
          f"against CPU and naive f32, relative L2 of dq, dk, dv): "
          f"{flash}; phase {figs['phase_s']:.1f} s, of which {secs}, "
          f"launches={counts}")
    return counts, inputs, figs


# ---------------------------------------------------------------------------
# phase TRAIN.DIST: training over several processes on the one card
# ---------------------------------------------------------------------------

DIST_BATCH, DIST_SEQ, DIST_STEPS, DIST_BITS = 4, 1024, 3, 8
DIST_PIPE_M, DIST_PIPE_SEQ = 6, 512
DIST_MOE_BATCH, DIST_MOE_SEQ = 2, 256
DIST_TIMEOUT = 900
LOSS_TOL_DIST = 5e-2          # tests/test_distributed.py's, both holds
# the kernels each sub-phase's children must launch: the pod exchange's
# bitpack pair inside the step, the compressed save's value-direct encode
# kernels (its leaves are 2^20-value chunks: the tiled quantize, not row
# 9's one-program kernel) and the restore's tiled walk
DIST_KERNELS = {
    "pod": ("pack", "unpack"),
    "save": ("gather_pack_tiled", "value_quant_tiles",
             "value_finalize_tiles", "dq_center"),
    "restore": ("hufdec_tiles",),
}


@contextlib.contextmanager
def wire_held(dispatch, tally):
    """Every CUDA pack_words / unpack_words call inside the block held
    bitwise against its plain version on the same card inputs; a pack of
    several pods' codes also row by row, the codes each pod's rank packs
    (the ranks unpack the gathered words, the same words). `tally` gets
    the held calls and the largest value count."""
    import torch
    fns = {op: dispatch.resolve(op, "cuda", "cuda") for op in WIRE_OPS}
    plains = {op: dispatch.resolve(op, "torch", "cuda") for op in WIRE_OPS}

    def hold(op, a):
        got = fns[op](*a)
        check(torch.equal(got, plains[op](*a)),
              f"phase TRAIN.DIST (b): {op} at {tuple(a[0].shape)} differs "
              f"from its plain version")
        tally[op] = tally.get(op, 0) + 1
        tally["values"] = max(tally.get("values", 0),
                              a[1] if op == "unpack_words" else a[0].numel())
        return got

    def pack(q, bits):
        out = hold("pack_words", (q, bits))
        if q.dim() == 2 and q.shape[0] > 1:
            for row in q.split(1):
                hold("pack_words", (row, bits))
        return out

    def unpack(words, n, bits):
        return hold("unpack_words", (words, n, bits))
    for op, fn in (("pack_words", pack), ("unpack_words", unpack)):
        dispatch.register(op, "cuda", lambda _f=fn: _f)
    try:
        yield
    finally:
        for op, fn in fns.items():
            dispatch.register(op, "cuda", lambda _f=fn: _f)


def dist_config(reduced=False):
    """gemma3-1b at its published widths and full vocabulary, its first
    repeat (6 of 26 layers: four replicas of the whole model's training
    state do not fit the card); `reduced`: its reduced config's first
    repeat (a rehearsal on the CPU)."""
    from repro_torch.configs import gemma3_1b
    return cut_units(gemma3_1b.get_reduced() if reduced else serve_config(),
                     n_units=1, repeat=1)


def dsynced(fn, dev):
    """fn() timed on the host clock, between syncs of `dev` when it is a
    card -> (result, seconds)."""
    import torch
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def peak_reset(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_read(dev):
    import torch
    return torch.cuda.max_memory_allocated() \
        if torch.device(dev).type == "cuda" else 0


def dist_mesh(shape, axes, dev):
    """A rank mesh of the running world: the card (cuda:0 for every rank on
    a one-card machine), or every rank on `dev`."""
    import numpy as np
    from repro_torch.launch import mesh as LM
    n = int(np.prod(shape))
    return LM.make_mesh(shape, axes, devices=None if torch_type(dev) ==
                        "cuda" else [dev] * n)


def torch_type(dev):
    import torch
    return torch.device(dev).type


def digest(t):
    """An exact fingerprint of a tensor's bits, taken on its device:
    (dtype, shape, the sum mod 2^64 of its 16- or 32-bit words times odd
    weights of their positions). One differing word always changes it
    (an odd weight is invertible mod 2^64)."""
    import torch
    x = t.detach().contiguous().reshape(-1)
    word = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[x.element_size()]
    bits = x.view(word)
    h = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, bits.numel(), 1 << 24):
        b = bits[i:i + (1 << 24)].to(torch.int64)
        w = torch.arange(i, i + b.numel(), dtype=torch.int64,
                         device=x.device) * -7046029254386353131 \
            + 1442695040888963407
        h = h + (b * (w | 1)).sum()
    return (str(t.dtype), tuple(t.shape), int(h))


def digests(tree):
    from repro_torch.convert import tree_items
    return {k: digest(v) for k, v in tree_items(tree)}


def slice_digests(whole, plan_of, coords):
    """{path: digest} of the block each leaf of `whole` ({path: tensor})
    the mesh position `coords` holds under the logical plan `plan_of`."""
    from repro_torch.runtime import sharding as S
    return {k: digest(v[S.shard_slices(tuple(v.shape), S.leaf_sharding(
        k, tuple(v.shape), plan_of), coords)]) for k, v in whole.items()}


def mesh_coords(shape, axes):
    """Each rank's {axis: coordinate} on a row-major mesh."""
    import numpy as np
    return [dict(zip(axes, (int(c) for c in np.unravel_index(r, shape))))
            for r in range(int(np.prod(shape)))]


def launch_diff(before, after):
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n - before.get(k, 0)}


def dist_train(rank, plan, cfg, tc, dev, seed, params0=None, grads0=None):
    """One rank's run of DIST_STEPS steps on its rows -> the state and
    the record: losses, step ms, the collectives' staging and gloo
    seconds and the exchange's seconds a step, digests of the init
    shards and of the shards after each step, the peak."""
    import torch
    from repro_torch.convert import tree_items
    from repro_torch.data.synthetic import (DataConfig, batch_for_step,
                                            batch_rows)
    from repro_torch.launch import train as TR
    from repro_torch.runtime import dist as D
    dc = DataConfig(vocab_size=cfg.vocab_size, global_batch=DIST_BATCH,
                    seq_len=DIST_SEQ, seed=seed)
    peak_reset(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    state = TR.init_state(seed, cfg, tc, plan, device=dev)
    rec = {"init": digests(state["params"]), "losses": [], "ms": [],
           "staging_s": [], "gloo_s": [], "exchange_s": [], "sent": [],
           "after": []}
    step = TR.make_train_step(cfg, tc, plan, device=dev,
                              keep_grads=grads0 is not None)
    held = [0.0]
    exchange = TR.compressed_cross_pod_mean

    def timed_exchange(*a, **kw):
        out, s = dsynced(lambda: exchange(*a, **kw), dev)
        held[0] += s
        return out
    with swapped((TR, "compressed_cross_pod_mean", timed_exchange)):
        for i in range(DIST_STEPS):
            rows = TR.batch_on(batch_rows(batch_for_step(dc, i),
                                          *plan.batch_index()), dev)
            held[0] = 0.0
            D.collect_stats(True)
            (state, m), s = dsynced(lambda: step(state, rows), dev)
            rec["ms"].append(s * 1e3)
            rec["staging_s"].append(D.STATS["staging_s"])
            rec["gloo_s"].append(D.STATS["exchange_s"])
            rec["sent"].append(D.STATS["bytes"])
            rec["exchange_s"].append(held[0])
            D.collect_stats(False)
            rec["losses"].append(float(m["loss"]))
            if i == 0 and grads0 is not None:
                g = m.pop("grads")
                rec["grad_digest"] = {k: digest(v) for k, v in g.items()}
                if rank == 0:
                    want = torch.load(grads0, map_location=dev)
                    rec["grad_rel"] = max((rel_l2(g[k], w), k)
                                          for k, w in want.items())
                    del want
                del g
            rec["after"].append(digests(state["params"]))
            print(f"rank {rank}: step {i} {s:.2f} s, loss "
                  f"{rec['losses'][-1]}, host max RSS "
                  f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} kB"
                  + (f", card allocated {torch.cuda.memory_allocated()} B, "
                     f"peak {torch.cuda.max_memory_allocated()} B"
                     if torch_type(dev) == "cuda" else ""), flush=True)
    torch.use_deterministic_algorithms(False)
    rec["peak"] = peak_read(dev)
    return state, rec


# ---------------------------------------------------------------------------
# phase SERVE.DIST: serving over the ranks of TRAIN.DIST's two worlds
# ---------------------------------------------------------------------------

# the world of 2 on (data=1, model=2): B 2, a 252-token prompt, 8 greedy
# steps into 512-slot caches, so positions 252-259 write into both model
# ranks' halves (slots 0-255 and 256-511) of every layer's cache. The
# world of 4 on (data=2, model=2): B 4 (2 rows a rank) and B 1 under
# decode_wide (the sequence over all 4 ranks), a 60-token prompt and 8
# steps into 128 slots (positions 60-67 cross the slices at 64, and the
# wide slices at 64 too)
SDIST_B2, SDIST_PROMPT2, SDIST_CACHE2 = 2, 252, 512
SDIST_B4, SDIST_PROMPT4, SDIST_CACHE4 = 4, 60, 128
SDIST_GEN = 8
SDIST_KERNELS = ("hufdec_tiles",)    # the world of 2's restores' walk


def sdist_prompt(cfg, B, P, seed, dev):
    """B x P prompt tokens from a generator of the seed on `dev`."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed + 67 + B)
    return torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                         device=dev, dtype=torch.int32)


def sdist_ingest(cfg, whole, prompt, cache_len, dev):
    """The prompt's decode cache: the prompt teacher-forced through the
    one-process decode over the whole weights `whole`. (A rank gathers
    its weights once for it: P gathered decode steps of the full
    vocabulary's table would take most of the run's time.)"""
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    B, P = prompt.shape
    dec = S.make_decode_fn(cfg, ShardingPlan(mesh=None), B, cache_len)[0]
    cache = T.init_cache(cfg, B, cache_len, device=dev)
    for t in range(P):
        _, cache = dec(whole, prompt[:, t], cache)
    return cache


def sdist_serve(pre, dec, params, prompt, cache, dev, tokens=None,
                keep=False):
    """Prefill `prompt`, then SDIST_GEN greedy decode steps from `cache`
    (the steps' inputs `tokens` when given), each call timed between
    syncs with dist.STATS on -> (the record: prefill and step logits'
    digests, the steps' input tokens, ms, gloo and staging seconds and
    bytes staged a call, with `keep` the logits themselves; the final
    cache). `params()` gives the weights a call uses."""
    import torch
    from repro_torch.runtime import dist as D
    rec = {"steps": [], "tokens": [], "ms": [], "gloo_s": [],
           "staging_s": [], "sent": [], "logits": []}

    def call(fn):
        D.collect_stats(True)
        out, s = dsynced(fn, dev)
        rec["ms"].append(s * 1e3)
        rec["gloo_s"].append(D.STATS["exchange_s"])
        rec["staging_s"].append(D.STATS["staging_s"])
        rec["sent"].append(D.STATS["bytes"])
        D.collect_stats(False)
        return out
    with torch.no_grad():
        logits = call(lambda: pre(params(), prompt))
        rec["prefill"] = digest(logits)
        if keep:
            rec["logits"].append(logits)
        for i in range(SDIST_GEN):
            tok = (logits.argmax(-1).to(torch.int32) if tokens is None
                   else tokens[i])
            rec["tokens"].append(tok)
            logits, cache = call(lambda: dec(params(), tok, cache))
            rec["steps"].append(digest(logits))
            if keep:
                rec["logits"].append(logits)
    return rec, cache


def sdist_rows(cache, rows):
    """Rows `rows` of a decode cache (the unit leaves' batch dimension
    follows their repeat axis)."""
    from repro_torch.convert import map_tree
    return map_tree(lambda k, v: v[:, rows] if k.startswith("units/")
                    else v[rows], cache)


def sdist_cat(caches):
    """Decode caches of consecutive row blocks joined along the batch."""
    import torch
    from repro_torch.convert import map_tree, tree_items
    flat = [dict(tree_items(c)) for c in caches]
    return map_tree(lambda k, _v: torch.cat(
        [f[k] for f in flat], dim=1 if k.startswith("units/") else 0),
        caches[0])


def sdist_cache_slices(cache, cfg, shape, B, cache_len, dev):
    """{coords key: {path: digest}} of the slice of `cache` (whole, B
    rows) each rank of a (data, model) mesh of `shape` holds by
    ``cache_shardings`` (a logical plan of the shape: the specs read only
    the mesh's shape)."""
    import numpy as np
    from repro_torch.convert import tree_items
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import serve as S
    from repro_torch.runtime import sharding as SH
    plan = SH.make_plan(LM.make_mesh(shape, ("data", "model"), devices=[
        dev] * int(np.prod(shape))))
    shd = dict(tree_items(S.make_decode_fn(cfg, plan, B, cache_len)[3][1]))
    return {str(c): {k: digest(v[SH.shard_slices(tuple(v.shape), shd[k],
                                                  coords=c)])
                     for k, v in tree_items(cache)}
            for c in mesh_coords(shape, ("data", "model"))}


def sdist_rank(plan, cfg, params, shards, prompt, cache_len, dev,
               keep=False):
    """One rank's request: its weights gathered once for the prompt's
    ingest (sdist_ingest, the whole batch), the cache placed as the
    rank's slices (``place_cache``), then the rank-aware prefill and
    greedy decode with `params()` (the rank's shards `shards`) gathered
    on use -> the record with the ingested, placed and final caches'
    digests."""
    from repro_torch.convert import map_tree
    from repro_torch.launch import serve as S
    from repro_torch.launch.train import param_shapes
    from repro_torch.runtime import sharding as SH
    B, P = prompt.shape
    shd = SH.param_shardings(shards, plan, shapes=param_shapes(cfg))
    whole = map_tree(lambda k, v: SH.gather_leaf(v, shd[k]), shards)
    cache0 = sdist_ingest(cfg, whole, prompt, cache_len, dev)
    del whole
    dec, _, _, (_, cs) = S.make_decode_fn(cfg, plan, B, cache_len)
    pre = S.make_prefill_fn(cfg, plan, B, P)[0]
    ingest = digests(cache0)
    cache = SH.place_cache(cache0, cs)
    del cache0
    start = digests(cache)
    rec, cache = sdist_serve(pre, dec, params, prompt, cache, dev,
                             keep=keep)
    rec.update(ingest=ingest, start=start, final=digests(cache),
               coords=str(plan.mesh.coords),
               logits=[x.float().cpu() for x in rec["logits"]],
               tokens=[t.cpu() for t in rec["tokens"]])
    return rec


def sdist_reference(cfg, whole, prompt, cache_len, shape, dev, blocks=1,
                    tokens=None, keep=False):
    """The parent's one-process serving of `prompt` over `whole`: the
    ingest of the whole batch, then prefill and greedy decode over each
    of `blocks` row blocks from its rows of that cache (`tokens`: the
    steps' inputs) -> the record of the blocks joined: the global
    logits' digests (with `keep`, the f32 logits on the host), the
    steps' tokens, the ingested cache's digests and the slices of the
    ingested and final caches each rank of a mesh of `shape` holds."""
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.runtime.sharding import ShardingPlan
    B, P = prompt.shape
    plan = ShardingPlan(mesh=None)
    cache0 = sdist_ingest(cfg, whole, prompt, cache_len, dev)
    per = B // blocks
    recs, finals = [], []
    for i in range(blocks):
        rows = slice(i * per, (i + 1) * per)
        dec = S.make_decode_fn(cfg, plan, per, cache_len)[0]
        pre = S.make_prefill_fn(cfg, plan, per, P)[0]
        rec, final = sdist_serve(
            pre, dec, lambda: whole, prompt[rows], sdist_rows(cache0, rows),
            dev, None if tokens is None else [t[rows] for t in tokens],
            keep=True)
        recs.append(rec)
        finals.append(final)
    logits = [torch.cat([r["logits"][i] for r in recs])
              for i in range(SDIST_GEN + 1)]
    out = {"prefill": digest(logits[0]),
           "steps": [digest(x) for x in logits[1:]],
           "tokens": [torch.cat([r["tokens"][i] for r in recs])
                      for i in range(SDIST_GEN)],
           "ingest": digests(cache0),
           "start": sdist_cache_slices(cache0, cfg, shape, B, cache_len,
                                       dev),
           "final": sdist_cache_slices(sdist_cat(finals), cfg, shape, B,
                                       cache_len, dev)}
    if keep:
        out["logits"] = [x.float().cpu() for x in logits]
    return out


def sdist_world2(rank, job, plan, cfg, dev):
    """Phase SERVE.DIST in the world of 2, on its (data=1, model=2)
    `plan`: the checkpoint of TRAIN.DIST (c) restored for serving, full
    and paged (both bf16, each rank its shards), then the B 2 request
    served through the paged store's pins (a collective pin a call)."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve as S
    out = {"launches": {}}
    peak_reset(dev)
    first = dispatch.launches()
    (full, meta), out["restore_s"] = dsynced(
        lambda: S.restore_serving_params(job["ckpt"], plan, device=dev), dev)
    out["launches"]["restore"] = launch_diff(first, dispatch.launches())
    out["meta"], out["full"] = meta, digests(full)
    del full
    before = dispatch.launches()

    def paged():
        store, _ = S.restore_serving_params(job["ckpt"], plan, paged=True,
                                            device=dev, cache_bytes=8 << 30)
        with store.pin() as pin:
            return store, pin.params()
    (store, shards), out["paged_s"] = dsynced(paged, dev)
    out["launches"]["paged"] = launch_diff(before, dispatch.launches())
    out["paged"] = digests(shards)
    out["restore_peak"] = peak_read(dev)

    def pinned():
        with store.pin() as pin:
            return pin.params()
    prompt = sdist_prompt(cfg, SDIST_B2, SDIST_PROMPT2, job["seed"], dev)
    try:
        out["run"] = sdist_rank(plan, cfg, pinned, shards, prompt,
                                SDIST_CACHE2, dev)
    finally:
        store.close()
    out["launches"]["serve"] = launch_diff(first, dispatch.launches())
    out["peak"] = peak_read(dev)
    return out


def sdist_world4(rank, job, cfg, dev):
    """Phase SERVE.DIST in the world of 4, on (data=2, model=2): weights
    drawn from the seed, each rank keeping its shards in bf16; the B 4 request (2 rows a
    rank, its logits kept) and the B 1 one under decode_wide."""
    import torch
    from repro_torch.convert import map_tree
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharding as SH
    plan = TR.make_plan_for(cfg, dist_mesh((2, 2), ("data", "model"), dev))
    out = {}
    peak_reset(dev)
    before = dispatch.launches()
    whole = T.init_params(job["seed"] + 61, cfg, device=dev)
    shd = SH.param_shardings(whole, plan)
    shards = map_tree(lambda k, v: SH.place(v.to(torch.bfloat16), shd[k]),
                      whole)
    del whole
    for B in (SDIST_B4, 1):
        prompt = sdist_prompt(cfg, B, SDIST_PROMPT4, job["seed"], dev)
        out[B] = sdist_rank(plan, cfg, lambda: shards, shards, prompt,
                            SDIST_CACHE4, dev, keep=B > 1 and rank == 0)
    out["launches"] = launch_diff(before, dispatch.launches())
    out["peak"] = peak_read(dev)
    return out


def sdist_world4_references(cfg, dev, seed):
    """The parent's references of the world of 4 on the card (taken
    beside the world of 2): the weights drawn as the ranks draw them, in
    bf16; B 4 over
    the two ranks' 2-row blocks (bitwise), then the whole batch fed the
    blocks' tokens (the bound); B 1 whole (bitwise, decode_wide)."""
    import torch
    from repro_torch.convert import map_tree
    from repro_torch.models import transformer as T
    whole = map_tree(lambda _k, v: v.to(torch.bfloat16),
                     T.init_params(seed + 61, cfg, device=dev))
    p4 = sdist_prompt(cfg, SDIST_B4, SDIST_PROMPT4, seed, dev)
    blocks = sdist_reference(cfg, whole, p4, SDIST_CACHE4, (2, 2), dev,
                             blocks=2)
    batch = sdist_reference(cfg, whole, p4, SDIST_CACHE4, (1, 1), dev,
                            tokens=[t.to(dev) for t in blocks["tokens"]],
                            keep=True)
    wide = sdist_reference(cfg, whole, sdist_prompt(
        cfg, 1, SDIST_PROMPT4, seed, dev), SDIST_CACHE4, (2, 2), dev)
    return {SDIST_B4: blocks, "batch": batch, 1: wide}


def sdist_check(name, got, want, coords, steps, index, blocks):
    """A rank's request record against the parent's: every logit digest,
    the ingested cache, the rank's placed and final cache slices; and
    that decode changed the rank's slice of a K or V leaf exactly where
    it holds a slot the positions `steps` wrote (its slice the index-th
    of `blocks` along the sequence; a ring's slot is pos % L)."""
    tag = f"phase SERVE.DIST ({name}), rank {coords}"
    check(got["ingest"] == want["ingest"],
          f"{tag}: the ingested prompt cache differs from the parent's")
    check(got["start"] == want["start"][coords],
          f"{tag}: the placed cache slices are not the parent's slices")
    check(got["prefill"] == want["prefill"],
          f"{tag}: the prefill logits differ from the one-process run's")
    bad = [i for i, (g, w) in enumerate(zip(got["steps"], want["steps"]))
           if g != w]
    check(len(got["steps"]) == SDIST_GEN and not bad,
          f"{tag}: decode steps {bad} differ from the one-process run's")
    bad = [k for k, v in want["final"][coords].items()
           if got["final"].get(k) != v]
    check(sorted(got["final"]) == sorted(want["final"][coords]) and not bad,
          f"{tag}: final cache slices {bad[:4]} differ from the parent's")
    kv = [k for k in got["final"] if k.endswith(("/k", "/v"))]
    check(bool(kv), f"{tag}: no K or V leaf")
    for k in kv:
        n = got["final"][k][1][2]           # (R, B, slots, K, D)
        mine = any(index * n <= p % (n * blocks) < (index + 1) * n
                   for p in steps)
        check((got["final"][k] != got["start"][k]) == mine,
              f"{tag}: decode {'left' if mine else 'wrote into'} {k}'s "
              f"slice, slots [{index * n}, {(index + 1) * n})")


def sdist_holds(r4, r2, want4, want2, want_full2, card, on_card):
    """Phase SERVE.DIST's holds on the worlds' records against the
    parent's references, and its figures (printed)."""
    w2c = mesh_coords((1, 2), ("data", "model"))
    w4c = mesh_coords((2, 2), ("data", "model"))
    for r, res in enumerate(r2):
        got, coords = res["serve"], str(w2c[r])
        tag = f"phase SERVE.DIST (world of 2), rank {coords}"
        check(got["meta"]["step"] == DIST_STEPS, f"{tag}: {got['meta']}")
        bad = [k for k, v in want_full2[r].items() if got["full"].get(k) != v]
        check(sorted(got["full"]) == sorted(want_full2[r]) and not bad,
              f"{tag}: restored shards {bad[:4]} are not the slices of the "
              f"parent's bf16 restore")
        check(got["paged"] == got["full"],
              f"{tag}: the paged leaves differ from the full restore's")
        for what in ("restore", "paged"):
            n = got["launches"][what]
            check(not on_card or all(n.get(k, 0) > 0 for k in SDIST_KERNELS),
                  f"{tag}: the {what} launched {n}")
        sdist_check("world of 2, B 2", got["run"], want2, coords,
                    range(SDIST_PROMPT2, SDIST_PROMPT2 + SDIST_GEN),
                    w2c[r]["model"], 2)
    steps = range(SDIST_PROMPT4, SDIST_PROMPT4 + SDIST_GEN)
    for r, res in enumerate(r4):
        coords, c = str(w4c[r]), w4c[r]
        sdist_check("world of 4, B 4", res["serve"][SDIST_B4],
                    want4[SDIST_B4], coords, steps, c["model"], 2)
        # decode_wide: the sequence over (data, model), row-major
        sdist_check("world of 4, B 1, decode_wide", res["serve"][1],
                    want4[1], coords, steps, 2 * c["data"] + c["model"], 4)
    kept = r4[0]["serve"][SDIST_B4]["logits"]
    bound = logit_stats(list(zip(kept, want4["batch"]["logits"])))
    check(len(kept) == SDIST_GEN + 1 and bound["ratio"] <= 1.0,
          f"phase SERVE.DIST (world of 4, B 4): the ranks' logits against "
          f"the parent's whole batch {bound}")
    med = lambda xs: statistics.median(xs) if xs else None
    runs = {"world2 B 2": [res["serve"]["run"] for res in r2],
            "world4 B 4": [res["serve"][SDIST_B4] for res in r4],
            "world4 B 1 wide": [res["serve"][1] for res in r4]}
    figs = {"whole_batch_vs_blocks": bound}
    for name, recs in runs.items():
        figs[name] = dict(
            prefill_ms=[rec["ms"][0] for rec in recs],
            decode_ms=[med(rec["ms"][1:]) for rec in recs],
            gloo_s=[med(rec["gloo_s"][1:]) for rec in recs],
            staging_s=[med(rec["staging_s"][1:]) for rec in recs],
            sent_bytes=[med(rec["sent"][1:]) for rec in recs],
            prefill_gloo_s=[rec["gloo_s"][0] for rec in recs],
            prefill_staging_s=[rec["staging_s"][0] for rec in recs])
    figs["world2"] = dict(restore_s=[res["serve"]["restore_s"] for res in r2],
                          paged_s=[res["serve"]["paged_s"] for res in r2],
                          restore_peak=[res["serve"]["restore_peak"]
                                        for res in r2],
                          peak=[res["serve"]["peak"] for res in r2])
    figs["world4"] = dict(peak=[res["serve"]["peak"] for res in r4])
    for name in runs:
        f = figs[name]
        print(f"dist phase SERVE.DIST ({name}) [{card}]: prefill ms by rank "
              f"{f['prefill_ms']}, decode ms a step (median) "
              f"{f['decode_ms']}; a decode step's gloo s {f['gloo_s']}, "
              f"staging s {f['staging_s']}, bytes staged "
              f"{f['sent_bytes']}; the prefill's gloo s "
              f"{f['prefill_gloo_s']}, staging s {f['prefill_staging_s']}")
    print(f"dist phase SERVE.DIST (world2) [{card}]: serving restore s "
          f"{figs['world2']['restore_s']}, paged s "
          f"{figs['world2']['paged_s']}, peak by rank "
          f"{figs['world2']['peak']} B (restores {figs['world2']['restore_peak']}"
          f" B); (world4) peak by rank {figs['world4']['peak']} B; B 4 "
          f"against the whole batch {bound}")
    return figs


def dist_world4(rank, job):
    """The 4-rank world of phase TRAIN.DIST: (a) (data=2, model=2) from
    the seed, step 0's gradients against the parent's; (b) (pod=2,
    data=1, model=2) without and with the compressed exchange; (c) the
    uncompressed run's state saved (compressed, the checkpoint's default
    mode) to job["ckpt"]; (d) the pipeline over 4 stages of one gemma3-1b
    block each; then phase SERVE.DIST's world of 4 (sdist_world4)."""
    import torch
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.optim import CompressionConfig
    from repro_torch.runtime.pipeline import pipeline_apply
    cfg, dev, seed = dist_config(job["reduced"]), job["dev"], job["seed"]
    out = {"launches": {}}
    t0 = time.perf_counter()
    plan = TR.make_plan_for(cfg, dist_mesh((2, 2), ("data", "model"), dev))
    print(f"rank {rank}: mesh {plan.mesh.shape} on "
          f"{plan.mesh.local_device}", flush=True)
    with compute_dtype(torch.float32):
        state, out["a"] = dist_train(rank, plan, cfg, TR.TrainConfig(), dev,
                                     seed, grads0=job["grads0"])
    print(f"rank {rank}: (a) {time.perf_counter() - t0:.1f} s", flush=True)
    del state
    torch.cuda.empty_cache()
    plan = TR.make_plan_for(cfg, dist_mesh(
        (2, 1, 2), ("pod", "data", "model"), dev))
    out["b"] = {}
    for comp in (False, True):
        tc = TR.TrainConfig(comp=CompressionConfig(bits=DIST_BITS,
                                                   enabled=comp))
        before = dispatch.launches()
        state, out["b"][comp] = dist_train(rank, plan, cfg, tc, dev, seed)
        out["launches"][f"b.{comp}"] = launch_diff(before,
                                                   dispatch.launches())
        print(f"rank {rank}: (b, comp={comp}) "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not comp:     # (c): the state without a residual, 2.8 GB
            before = dispatch.launches()
            peak_reset(dev)
            _, s = dsynced(lambda: C.save_checkpoint(
                job["ckpt"], state, step=DIST_STEPS, device=dev, plan=plan,
                shapes=TR.state_shapes(cfg, state)), dev)
            out["save_s"] = s
            out["save_peak"] = peak_read(dev)
            out["launches"]["save"] = launch_diff(before,
                                                  dispatch.launches())
            print(f"rank {rank}: (c) saved in {s:.1f} s", flush=True)
        del state
    # (d) the pipeline: 4 stages of one block each, f32
    mesh = dist_mesh((4,), ("stage",), dev)
    stacked, mbs, stage_fn = pipe_inputs(cfg, dev, seed)
    with compute_dtype(torch.float32):
        got, s = dsynced(lambda: pipeline_apply(stage_fn, stacked, mbs,
                                                mesh, "stage"), dev)
    out["pipe"] = {"digest": digest(got), "s": s}
    del stacked, mbs, got
    # SERVE.DIST: serving over the same ranks
    t1 = time.perf_counter()
    out["serve"] = sdist_world4(rank, job, cfg, dev)
    out["serve"]["s"] = time.perf_counter() - t1
    print(f"rank {rank}: SERVE.DIST {out['serve']['s']:.1f} s", flush=True)
    return out


def pipe_inputs(cfg, dev, seed):
    """Phase TRAIN.DIST (d): 4 stacked draws of gemma3-1b's first block
    (its published widths), DIST_PIPE_M microbatches of (1, DIST_PIPE_SEQ,
    d_model) f32, and the stage function (the block in the compute
    dtype)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    blk = cfg.units[0].blocks[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    stacked = T._stack([T._block_init(gen, blk, cfg.d_model)
                        for _ in range(4)])
    mbs = torch.randn((DIST_PIPE_M, 1, DIST_PIPE_SEQ, cfg.d_model),
                      generator=gen, device=dev)
    pos = torch.arange(DIST_PIPE_SEQ, device=dev)[None]
    zero = torch.zeros((), device=dev)
    plan = ShardingPlan(mesh=None)

    def stage_fn(p, x):
        return T._block_apply(p, blk, x, pos, plan, zero, None)[0]
    return stacked, mbs, stage_fn


def moe_inputs(dev, seed, reduced=False):
    """Phase TRAIN.DIST (e): phi3.5-moe's MoE block at its published
    widths (16 experts of 4096 x 6400, top 2; `reduced`: its reduced
    config's) drawn on the card, and DIST_MOE_BATCH x DIST_MOE_SEQ bf16
    tokens."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import modules as M
    spec = get_arch(MOE_PHI)
    cfg = (spec.reduced() if reduced else spec.config()) \
        .units[0].blocks[0].moe
    gen = torch.Generator(device=dev).manual_seed(seed + 47)
    p = M.moe_init(gen, cfg)
    x = torch.randn((DIST_MOE_BATCH, DIST_MOE_SEQ, cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    return cfg, p, x


def dist_world2(rank, job):
    """The 2-rank world of phase TRAIN.DIST: (c) the 4-rank save restored
    onto (data=1, model=2); (e) the MoE expert-parallel over model=2;
    then phase SERVE.DIST's world of 2 (sdist_world2)."""
    import torch
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train as TR
    from repro_torch.models import modules as M
    from repro_torch.runtime import sharding as S
    cfg, dev = dist_config(job["reduced"]), job["dev"]
    out = {"launches": {}}
    plan = TR.make_plan_for(cfg, dist_mesh((1, 2), ("data", "model"), dev))
    before = dispatch.launches()
    peak_reset(dev)
    (state, meta), s = dsynced(lambda: C.restore_checkpoint(
        job["ckpt"], plan=plan, device=dev), dev)
    out["launches"]["restore"] = launch_diff(before, dispatch.launches())
    out["restore"] = {"s": s, "meta": meta, "digests": digests(state),
                      "model": plan.mesh.shape["model"],
                      "peak": peak_read(dev)}
    del state
    mcfg, p, x = moe_inputs(dev, job["seed"], job["reduced"])
    nl = mcfg.n_experts // 2
    cap = M._moe_capacity(x.shape[0] * x.shape[1], mcfg, nl)
    with torch.no_grad():
        (y, aux), s = dsynced(lambda: M.moe_apply(p, mcfg, x, plan), dev)
        _, _, r = M.moe_local_math(
            x.reshape(-1, mcfg.d_model), M._expert_slice(
                p["moe"], rank * nl, nl), mcfg, rank * nl, nl, cap,
            with_route=True)
    out["moe"] = {"y": digest(y), "aux": float(aux), "s": s, "cap": cap,
                  "route": {k: digest(r[k]) for k in sorted(r)},
                  "kept": int(r["valid"].sum()),
                  "dropped": int((r["pos"] >= cap).sum())}
    del p, x, y, r
    # SERVE.DIST: the checkpoint served over the same ranks
    t1 = time.perf_counter()
    out["serve"] = sdist_world2(rank, job, plan, cfg, dev)
    out["serve"]["s"] = time.perf_counter() - t1
    print(f"rank {rank}: SERVE.DIST {out['serve']['s']:.1f} s", flush=True)
    return out


def run_dist_phase(dispatch, card, tmp, seed, dev="cuda", reduced=False,
                   captured=None):
    """Phase TRAIN.DIST: training over several processes, each a rank of
    a gloo world on the one card (``runtime/dist.py``: every exchange
    staged through the host), on gemma3-1b's first repeat at its
    published widths (dist_config). The parent runs the one-process
    references on the card first, hands the card back, then launches:

      world of 4 (dist_world4): (a) (data=2, model=2), global batch
      DIST_BATCH x DIST_SEQ, DIST_STEPS steps in f32 compute (the
      gradients' bound, 2^-7, is phase TRAIN's in f32: bf16 products
      round otherwise over 2 rows than over 4): losses within 5e-2 of the
      parent's one-process run, step 0's whole gradients within 2^-7 of
      its, alike on every rank, every rank's shards after init bitwise
      the slices of the parent's leaves; (b) (pod=2, data=1, model=2),
      DIST_BITS bits, without and with the compressed exchange: every
      step's loss and every rank's shards bitwise the parent's
      one-process emulation on a logical mesh, the compressed losses
      within 0.05 of the uncompressed, rows 15-16 launched in the step,
      and every pack and unpack of the compressed emulation on the card
      bitwise their plain versions on the same inputs (wire_held);
      (c) the uncompressed run's state (params and moments, 2.8 GB)
      saved compressed from the 4 ranks (rank 0 writes); (d) the pipeline, 4 stages of one block, DIST_PIPE_M
      microbatches of (1, DIST_PIPE_SEQ, 1152) f32: bitwise the parent's
      sequential_reference.
      world of 2 (dist_world2): (c) that checkpoint restored onto (data=1,
      model=2): every rank's shards bitwise the slices of the parent's
      one-process restore; (e) phi3.5-moe's MoE block over model=2 (8
      experts a rank), DIST_MOE_BATCH x DIST_MOE_SEQ bf16 tokens: the
      output and each rank's routing, capacity and drops bitwise the
      parent's moe_block_by_shards.

    The train steps run with torch's deterministic algorithms (warn
    only) on both sides, so an embedding gradient's additions take one
    order. `dev` and `reduced` (the CPU and reduced configs) rehearse the
    phase without a card; `captured`, the recorders' kept arguments, is
    emptied before the children start (the ranks need the card's
    memory). -> (the children's launch counts summed, figures)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.convert import map_tree, tree_items
    from repro_torch.data.synthetic import DataConfig, batch_for_step
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train as TR
    from repro_torch.models import modules as M
    from repro_torch.optim import CompressionConfig
    from repro_torch.runtime import dist as D
    from repro_torch.runtime.pipeline import sequential_reference
    from repro_torch.runtime.sharding import ShardingPlan
    t_phase = time.perf_counter()
    secs = {}
    if torch_type(dev) == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"dist phase TRAIN.DIST: the parent holds "
              f"{torch.cuda.memory_allocated()} B on the card; {free} of "
              f"{total} B free")
    cfg, plan0 = dist_config(reduced), ShardingPlan(mesh=None)
    n_params = meta_count(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, global_batch=DIST_BATCH,
                    seq_len=DIST_SEQ, seed=seed)
    d = os.path.join(tmp, "dist")
    os.makedirs(d, exist_ok=True)
    grads0, ckpt = os.path.join(d, "grads0.pt"), os.path.join(d, "ckpt")
    logical = lambda shape, axes: TR.make_plan_for(cfg, LM.make_mesh(
        shape, axes, devices=[dev] * int(np.prod(shape))))
    batches = [TR.batch_on(batch_for_step(dc, i), dev)
               for i in range(DIST_STEPS)]
    # the parent's one-process references on the card
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    state = TR.init_state(seed, cfg, TR.TrainConfig(), plan0, device=dev)
    whole = dict(tree_items(state["params"]))
    a_plan = logical((2, 2), ("data", "model"))
    want_a = [slice_digests(whole, a_plan, c)
              for c in mesh_coords((2, 2), ("data", "model"))]
    step = TR.make_train_step(cfg, TR.TrainConfig(), plan0, device=dev,
                              keep_grads=True)
    one_losses = []
    with compute_dtype(torch.float32):
        for i, b in enumerate(batches):
            state, m = step(state, b)
            one_losses.append(float(m["loss"]))
            if i == 0:
                torch.save({k: v.cpu() for k, v in m["grads"].items()},
                           grads0)
            del m
    del state, whole, step
    b_shape, b_axes = (2, 1, 2), ("pod", "data", "model")
    b_plan = logical(b_shape, b_axes)
    want_b, wire = {}, {}
    for comp in (False, True):
        tc = TR.TrainConfig(comp=CompressionConfig(bits=DIST_BITS,
                                                   enabled=comp))
        state = TR.init_state(seed, cfg, tc, b_plan, device=dev)
        step = TR.make_train_step(cfg, tc, b_plan, device=dev)
        want_b[comp] = {"losses": [], "after": []}
        for b in batches:
            # the compressed emulation's every pack and unpack (rows
            # 15-16 at the leaves' whole lengths, the table's 302 M
            # values a pod the largest) held against the plain versions
            with wire_held(dispatch, wire) if comp else \
                    contextlib.nullcontext():
                state, m = step(state, b)
            want_b[comp]["losses"].append(float(m["loss"]))
            p = dict(tree_items(state["params"]))
            want_b[comp]["after"].append(
                [slice_digests(p, b_plan, c)
                 for c in mesh_coords(b_shape, b_axes)])
            del m, p
        del state, step
    torch.use_deterministic_algorithms(False)
    if torch_type(dev) == "cuda":
        check(wire.get("pack_words", 0) > 0
              and wire.get("unpack_words", 0) > 0,
              f"phase TRAIN.DIST (b): the emulation's exchange held {wire}")
    print(f"dist phase TRAIN.DIST (b): the emulation's pack_words and "
          f"unpack_words calls bitwise their plain versions on {dev}: "
          f"{wire}", flush=True)
    stacked, mbs, stage_fn = pipe_inputs(cfg, dev, seed)
    with compute_dtype(torch.float32):
        want_pipe = digest(sequential_reference(stage_fn, stacked, mbs))
    del stacked, mbs, batches
    if captured is not None:
        captured.clear()
    if torch_type(dev) == "cuda":
        torch.cuda.empty_cache()
        # four processes share the card: fewer reserved, unused blocks
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    secs["references"] = time.perf_counter() - t0
    print(f"dist phase TRAIN.DIST: the parent's references "
          f"{secs['references']:.1f} s", flush=True)
    # the world of 4 (the kernels were built before: the children reuse
    # the library)
    t0 = time.perf_counter()
    job = {"seed": seed, "grads0": grads0, "ckpt": ckpt, "dev": str(dev),
           "reduced": reduced}
    w4 = D.launch(dist_world4, 4, args=(job,), timeout=DIST_TIMEOUT,
                  echo=True)
    secs["world4"] = time.perf_counter() - t0
    print(f"dist phase TRAIN.DIST: the world of 4 {secs['world4']:.1f} s",
          flush=True)
    os.remove(grads0)
    # the world of 2, while the parent takes its one-process restore and
    # MoE shards (the decodes are host-bound: they overlap)
    t0 = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    w2_run = pool.submit(D.launch, dist_world2, 2, args=(job,),
                         timeout=DIST_TIMEOUT, echo=True)
    restored, meta = C.restore_checkpoint(ckpt, device=dev)
    rest = {k: torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v for k, v in tree_items(restored)}
    c_plan = logical((1, 2), ("data", "model"))
    want_c = [slice_digests({k: v.to(dev) for k, v in rest.items()},
                            c_plan, c)
              for c in mesh_coords((1, 2), ("data", "model"))]
    # SERVE.DIST's references of the world of 2: the restored params cast
    # to bf16 on the host leaf by leaf, as the serving restore casts them
    t1 = time.perf_counter()
    params2 = map_tree(lambda k, _v: rest[k].to(torch.bfloat16).to(dev),
                       restored["params"], "params/")
    del restored, rest
    want_full2 = [slice_digests(dict(tree_items(params2)), c_plan, c)
                  for c in mesh_coords((1, 2), ("data", "model"))]
    want_s2 = sdist_reference(cfg, params2, sdist_prompt(
        cfg, SDIST_B2, SDIST_PROMPT2, seed, dev), SDIST_CACHE2, (1, 2), dev)
    del params2
    secs["serve_references2"] = time.perf_counter() - t1
    # ... and of the world of 4 (the world of 2 takes longer than the
    # parent's work beside it)
    t1 = time.perf_counter()
    want_s4 = sdist_world4_references(cfg, dev, seed)
    secs["serve_references4"] = time.perf_counter() - t1
    mcfg, p, x = moe_inputs(dev, seed, reduced)
    cap = M._moe_capacity(x.shape[0] * x.shape[1], mcfg,
                          mcfg.n_experts // 2)
    with torch.no_grad():
        y1, aux1, routes = M.moe_block_by_shards(
            x.reshape(-1, mcfg.d_model), p["moe"], mcfg, 2, cap,
            with_routes=True)
    want_e = {"y": digest(y1.reshape(x.shape)), "aux": float(aux1),
              "routes": [{k: digest(r[k]) for k in sorted(r)}
                         for r in routes]}
    del p, x, y1, routes
    if captured is not None:
        captured.clear()
    if torch_type(dev) == "cuda":
        torch.cuda.empty_cache()
    secs["restore_and_moe_references"] = time.perf_counter() - t0
    w2 = w2_run.result()
    pool.shutdown()
    secs["world2"] = time.perf_counter() - t0
    # the holds
    r4 = [r.result for r in w4]
    r2 = [r.result for r in w2]
    for r, res in enumerate(r4):
        a = res["a"]
        check(a["init"] == want_a[r],
              f"phase TRAIN.DIST (a): rank {r}'s shards after init are not "
              f"the slices of the one-process leaves")
        check(all(abs(x - y) < LOSS_TOL_DIST
                  for x, y in zip(a["losses"], one_losses)),
              f"phase TRAIN.DIST (a): rank {r}'s losses {a['losses']} "
              f"against one process {one_losses}")
        check(a["grad_digest"] == r4[0]["a"]["grad_digest"],
              f"phase TRAIN.DIST (a): rank {r}'s gradients differ from "
              f"rank 0's")
        for comp in (False, True):
            b = res["b"][comp]
            check(b["losses"] == want_b[comp]["losses"],
                  f"phase TRAIN.DIST (b, comp={comp}): rank {r}'s losses "
                  f"{b['losses']} against the emulation "
                  f"{want_b[comp]['losses']}")
            for i, got in enumerate(b["after"]):
                bad = [k for k, v in got.items()
                       if v != want_b[comp]["after"][i][r][k]]
                check(not bad, f"phase TRAIN.DIST (b, comp={comp}): step "
                      f"{i}, rank {r}'s shards {bad[:4]} differ from the "
                      f"emulation's")
        check(res["pipe"]["digest"] == want_pipe,
              f"phase TRAIN.DIST (d): rank {r}'s pipeline output is not "
              f"sequential_reference's")
    grad_rel = r4[0]["a"]["grad_rel"]
    check(grad_rel[0] <= GRAD_REL,
          f"phase TRAIN.DIST (a): step 0's gradients {grad_rel} past "
          f"{GRAD_REL}")
    base, comp = want_b[False]["losses"], want_b[True]["losses"]
    check(all(abs(x - y) < 0.05 for x, y in zip(base, comp)),
          f"phase TRAIN.DIST (b): compressed {comp} against {base}")
    check(all(np.isfinite(x) for x in one_losses + base + comp),
          "phase TRAIN.DIST: a loss is not finite")
    for r, res in enumerate(r2):
        c = res["restore"]
        check(c["model"] == 2 and c["meta"]["step"] == DIST_STEPS,
              f"phase TRAIN.DIST (c): restored {c['meta']}")
        bad = [k for k, v in c["digests"].items() if v != want_c[r].get(k)]
        check(sorted(c["digests"]) == sorted(want_c[r]) and not bad,
              f"phase TRAIN.DIST (c): rank {r}'s restored shards {bad[:4]} "
              f"are not the one-process restore's")
        e = res["moe"]
        check(e["y"] == want_e["y"] and e["aux"] == want_e["aux"],
              f"phase TRAIN.DIST (e): rank {r}'s MoE output is not the "
              f"one-process sum of the shards")
        check(e["route"] == want_e["routes"][r] and e["cap"] == cap,
              f"phase TRAIN.DIST (e): rank {r}'s routing differs")
    serve_figs = sdist_holds(r4, r2, want_s4, want_s2, want_full2, card,
                             torch_type(dev) == "cuda")
    # the children's counts: SERVE.DIST's own, TRAIN.DIST the rest
    counts, serve_counts = {}, {}
    for res in [r.launches for r in w4 + w2]:
        for k, n in res.items():
            counts[k] = counts.get(k, 0) + n
    for got in [res["serve"]["launches"] for res in r4] + \
            [res["serve"]["launches"]["serve"] for res in r2]:
        for k, n in got.items():
            serve_counts[k] = serve_counts.get(k, 0) + n
            counts[k] -= n
    for res in r4:
        pod = res["launches"]["b.True"]
        check(all(pod.get(k, 0) > 0 for k in DIST_KERNELS["pod"]),
              f"phase TRAIN.DIST (b): the exchange launched {pod}")
        check(not any(res["launches"]["b.False"].get(k, 0)
                      for k in DIST_KERNELS["pod"]),
              "phase TRAIN.DIST (b): the uncompressed run packed")
    save = r4[0]["launches"]["save"]
    check(all(save.get(k, 0) > 0 for k in DIST_KERNELS["save"]),
          f"phase TRAIN.DIST (c): the save launched {save}")
    for res in r2:
        got = res["launches"]["restore"]
        check(all(got.get(k, 0) > 0 for k in DIST_KERNELS["restore"]),
              f"phase TRAIN.DIST (c): a restore launched {got}")
    # the figures
    med = lambda xs: statistics.median(xs)
    share = lambda rec, key: [x / (ms / 1e3) for x, ms in
                              zip(rec[key], rec["ms"])]
    figs = dict(params=n_params, one_process_losses=one_losses,
                grad_rel=grad_rel, seconds=secs, wire_held=wire,
                emulated_losses={str(c): want_b[c]["losses"]
                                 for c in want_b})
    for name, recs in (("a", [res["a"] for res in r4]),
                       ("b.plain", [res["b"][False] for res in r4]),
                       ("b.compressed", [res["b"][True] for res in r4])):
        figs[name] = dict(
            losses=recs[0]["losses"],
            step_ms=[rec["ms"] for rec in recs],
            median_step_ms=med([ms for rec in recs for ms in rec["ms"][1:]]),
            staging_share=[share(rec, "staging_s") for rec in recs],
            gloo_share=[share(rec, "gloo_s") for rec in recs],
            exchange_share=[share(rec, "exchange_s") for rec in recs],
            sent_bytes=[rec["sent"] for rec in recs],
            peak=[rec["peak"] for rec in recs])
    figs["save_s"] = [res.get("save_s") for res in r4]
    figs["save_peak"] = [res.get("save_peak") for res in r4]
    figs["restore_s"] = [res["restore"]["s"] for res in r2]
    figs["restore_peak"] = [res["restore"]["peak"] for res in r2]
    figs["pipe_s"] = [res["pipe"]["s"] for res in r4]
    figs["moe"] = [{k: res["moe"][k] for k in ("s", "cap", "kept",
                                               "dropped", "aux")}
                   for res in r2]
    figs["max_memory"] = {"world4": [r.max_memory for r in w4],
                          "world2": [r.max_memory for r in w2]}
    figs["child_s"] = {"world4": [r.seconds for r in w4],
                       "world2": [r.seconds for r in w2]}
    figs["phase_s"] = time.perf_counter() - t_phase
    for name in ("a", "b.plain", "b.compressed"):
        f = figs[name]
        print(f"dist phase TRAIN.DIST ({name}) [{card}]: {n_params} "
              f"parameters, global batch {DIST_BATCH} x S {DIST_SEQ}: step "
              f"ms by rank {f['step_ms']} (median after the first "
              f"{f['median_step_ms']}); gloo staging share "
              f"{f['staging_share']}, gloo exchange share {f['gloo_share']}, "
              f"compressed exchange share {f['exchange_share']}; bytes "
              f"sent {f['sent_bytes']}; peak allocated by rank {f['peak']} "
              f"B; losses {f['losses']}")
    print(f"dist phase TRAIN.DIST [{card}]: one-process losses {one_losses}"
          f", step 0's gradients worst leaf {grad_rel}; save from 4 ranks "
          f"{figs['save_s']} s (peak {figs['save_peak']} B), restore onto 2 "
          f"ranks {figs['restore_s']} s (peak {figs['restore_peak']} B); "
          f"pipeline {figs['pipe_s']} s; MoE EP {figs['moe']}; children's "
          f"max allocated {figs['max_memory']} B, seconds "
          f"{figs['child_s']}; phase {figs['phase_s']:.1f} s, of which "
          f"{secs}, launches={counts}")
    figs["SERVE.DIST"] = serve_figs
    serve_figs["launches"] = serve_counts
    serve_figs["seconds"] = {
        "world4": [res["serve"]["s"] for res in r4],
        "world2": [res["serve"]["s"] for res in r2],
        "references": {k: secs[k] for k in ("serve_references4",
                                            "serve_references2")}}
    print(f"dist phase SERVE.DIST [{card}]: seconds "
          f"{serve_figs['seconds']}, launches={serve_counts}")
    return {"TRAIN.DIST": counts, "SERVE.DIST": serve_counts}, figs


def zoo_kernel_rows(timed, rows):
    """Row 4 at the walk shapes phases SERVE.MOE, SERVE.ZOO and SERVE.SSM
    gave it
    (hold_kept_walks) and no earlier phase did: one case a (C, NB, bs),
    timed (plain versions held, not timed)."""
    cuda, plain = walk_fns("hufdec_tiles")
    row = rows.get("hufdec_tiles", {})
    have = {tuple(c["shape"]) for c in row.get("cases", [])
            if c.get("shape")} | ({tuple(row["shape"])} if "shape" in row
                                  else set())
    for (C, NB, bs), (phase, d) in sorted(timed.items()):
        if (C, NB, bs) in have:
            continue
        add_case(rows, "hufdec_tiles", lambda: cuda(d), lambda: plain(d),
                 in_bytes=nbytes(*d[:6]), out_bytes=4 * C * NB * bs,
                 ops=12 * int(d[2].sum()),
                 extra=dict(phase=phase, shape=[C, NB, bs]),
                 time_plain=False)


def install_recorders(dispatch):
    """The censuses' wrappers (rows 3, 9, 13 and 7) and, on every
    captured dispatch op's CUDA implementation, a recorder: outside
    SIGHT_PHASES it keeps each op's first call of a counted run (and
    the calls KEEP_CALLS picks); in them, the SIGHT_OPS are held at
    first sight and only the KEEP_CALLS calls kept. The wire ops keep
    their call with the most values. -> (censuses, the captured dict)."""
    from repro_torch.kernels.dualquant import ops as DQ
    from repro_torch.kernels.hufenc import ops as HE
    from repro_torch.kernels.megakernel import ops as MK
    census = Censuses()
    HE.encode_pack_cuda = census.pack.wrap(HE.encode_pack_cuda)
    MK.ceaz_chunk_cuda = census.op.wrap(MK.ceaz_chunk_cuda)
    DQ.dq_center_cuda = census.center.wrap(DQ.dq_center_cuda)
    # row 7: the one-launch wrapper, or a parent's per-block packer (whose
    # launches are counted under the same name)
    flat = "hufenc_cuda" if hasattr(HE, "hufenc_cuda") else \
        "hufenc_blocks_cuda"
    setattr(HE, flat, census.flat.wrap(getattr(HE, flat)))
    captured = {}
    for op in CAPTURED_OPS:
        if not dispatch.available(op):
            continue
        fn = dispatch.resolve(op, "cuda", "cuda")
        plain = dispatch.resolve(op, "torch", "cuda")

        def recorder(*a, _fn=fn, _op=op, _plain=plain):
            keep = KEEP_CALLS.get(_op)
            if keep is not None and keep(a):
                captured.setdefault(_op + ".kept", []).append(a)
            if SIGHT.phase is None:
                captured.setdefault(_op, (a,))
            elif _op in SIGHT_OPS:
                key = tuple(tuple(x.shape) if hasattr(x, "shape") else x
                            for x in a)
                return SIGHT.call(_op, key, _fn, _plain, SIGHT_OPS[_op], a)
            return _fn(*a)
        dispatch.register(op, "cuda", lambda _r=recorder: _r)
    for op in WIRE_OPS:
        fn = dispatch.resolve(op, "cuda", "cuda")

        def largest(*a, _fn=fn, _op=op):
            old = captured.get(_op)
            if old is None or a[0].numel() > old[0][0].numel():
                captured[_op] = (a,)
            return _fn(*a)
        dispatch.register(op, "cuda", lambda _r=largest: _r)
    return census, captured


PHASES = (
    # name, field, facade options (rel eb 1e-4 unless given)
    ("A", "cesm", {}),
    ("B", "hacc", dict(chunk_bytes=1 << 19)),
    ("C", "hacc", dict(chunk_bytes=1 << 19, codebook="bank")),
    ("C.value", "nwchem", dict(eb=1e-3, chunk_bytes=1 << 19,
                               predictor="none", codebook="bank")),
    ("D", "hacc", dict(codebook="bank")),
    # value-direct at rel 1e-3: at 1e-4 the whole field spans ~5000
    # quantization bins, over half its values escape as outliers and the
    # bank route (rightly) falls back to exact codebooks
    ("E.bank", "nwchem", dict(eb=1e-3, predictor="none", codebook="bank")),
    ("E.exact", "nwchem", dict(eb=1e-3, predictor="none")),
    # ... and the drift valve at 1e-4 (the fallback must be taken)
    ("E.drift", "nwchem", dict(predictor="none", codebook="bank")),
    ("F", "cesm", dict(codebook="bank")),
    # fixed-ratio mode on the HACC field in 64 chunks of 2^17
    ("G", "hacc", dict(mode="fixed_ratio", target_ratio=10.0,
                       chunk_bytes=1 << 19)),
    ("G.off", "hacc", dict(mode="fixed_ratio", target_ratio=10.0,
                           chunk_bytes=1 << 19, speculation="off")),
    ("G.bank", "hacc", dict(mode="fixed_ratio", target_ratio=10.0,
                            chunk_bytes=1 << 19, codebook="bank")),
    # the staged route (use_fused=False, backend 'torch')
    ("T.A", "cesm", dict(use_fused=False)),
    ("T.E", "nwchem", dict(use_fused=False, eb=1e-3, predictor="none")),
    ("T.G", "hacc_tg", dict(use_fused=False, mode="fixed_ratio",
                            target_ratio=10.0, chunk_bytes=1 << 17)),
)
# T.G's field: the HACC field's first 2^21 values (64 chunks of 2^15; its
# staged host decode and CPU run take ~1 s a chunk of the run's time)
T_G_VALUES = 1 << 21


def main():
    import argparse
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase P's fields and phase Q's params "
                         "and gradients")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the directory repro_torch is imported from "
                         "(default: this checkout's src); e.g. a git "
                         "archive of the parent commit's src, to measure "
                         "it with this same script")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import repro_torch
    check(os.path.abspath(repro_torch.__file__).startswith(src + os.sep),
          f"repro_torch was not imported from {src}")
    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    from repro_torch.core import CEAZ, CEAZConfig, default_offline_codebook
    from repro_torch.data import fields as F
    from repro_torch.kernels import _build, dispatch

    card = card_line()
    print(f"card: {card}")
    t_start = t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'ran' if _build.build_seconds else 'reused a build'})")
    for line in _build.ptxas_log().splitlines():
        if "registers" in line or line.startswith("=="):
            print("  ptxas:", line.strip())

    # training over several processes first, while the card holds nothing
    # of the other phases (and before the recorders keep any argument):
    # its 4 ranks need most of the card
    import tempfile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        dist_counts, dist_figs = run_dist_phase(dispatch, card, tmp,
                                                args.seed)
    torch.cuda.empty_cache()
    census, captured = install_recorders(dispatch)
    offline = default_offline_codebook()
    fields = {"cesm": F.cesm_proxy(size="medium"),
              "hacc": F.hacc_proxy(size="medium"),
              "nwchem": F.nwchem_proxy(size="medium")}
    check(fields["cesm"].shape == (1800, 3600)
          and fields["hacc"].shape == (1 << 23,)
          and fields["nwchem"].shape == (1 << 23,), "unexpected phase shapes")
    fields["hacc_tg"] = np.ascontiguousarray(fields["hacc"][:T_G_VALUES])
    counts, inputs, thr, streams, kws = {}, {}, {}, {}, {}
    for name, field, kw in PHASES:
        kws[name] = {"mode": "rel", "eb": 1e-4, **kw}
        counts[name], inputs[name], thr[name], streams[name] = run_phase(
            name, fields[field], kws[name], offline, dispatch, CEAZ,
            CEAZConfig, captured, census)
    assert_same_stream(streams["G.off"][0], streams["G"][0],
                       "phase G vs G.off")
    print("phase G stream == speculation 'off' stream on the card: True")
    for staged, fused in STAGED_TWINS.items():
        assert_same_stream(streams[staged][0], streams[fused][0],
                           f"phase {staged} vs phase {fused} (fused)")
    fused_kw = {k: v for k, v in kws["T.G"].items() if k != "use_fused"}
    assert_same_stream(streams["T.G"][0], CEAZ(
        CEAZConfig(device="cuda", **fused_kw), offline_codebook=offline)
        .compress(fields["hacc_tg"]), "phase T.G vs the fused route")
    print("staged streams == fused streams (T.A == A, T.E == E.exact, T.G "
          "== fused at its settings) on the card: True")
    c, i, t = run_batch_phases(fields["hacc"], offline, dispatch, CEAZ,
                               CEAZConfig, captured, census)
    counts.update(c)
    inputs.update(i)
    thr.update(t)
    for src, name in SPLIT_PHASES.items():
        counts[name], inputs[name], thr[name] = run_split_phase(
            name, *streams[src], kws[src], offline, dispatch, CEAZ,
            CEAZConfig, captured)
    for op, phases in (("dualquant", "ABF"), ("hufenc", "ABF"),
                       ("ceaz_chunk_dec", "ABCD"), ("ceaz_chunk", "CD"),
                       ("bank_select", "F")):
        for p in phases:
            check(op in inputs[p], f"{op} inputs of phase {p} not captured")
    check("ceaz_chunk" in inputs["C.value"]
          and "ceaz_chunk" in inputs["E.bank"]
          and "dq_center" in inputs["E.exact"], "phase E inputs not captured")
    check(all("histogram" in inputs[p] for p in ("A", "B", "T.G", "G.off"))
          and "gather_pack" in inputs["T.G"]
          and all(any(op in inputs[p] for op in ROW7_OPS)
                  for p in ("T.A", "T.E")),
          "phase A/B/T inputs not captured")
    check("lorenzo_quant" in inputs["G"] and "dualquant" in inputs["G.off"]
          and "ceaz_chunk" in inputs["G.bank"]
          and all("hufdec" in inputs[p] for p in SPLIT_PHASES.values()),
          "phase G/S inputs not captured")

    # the fixed-width wire path: P, Q, Q.snap
    nyx = [F.nyx_proxy(seed=5 + N_RANKS * args.seed + r, size="medium")
           for r in range(N_RANKS)]
    check(all(f.shape == (256, 256, 256) for f in nyx),
          "unexpected phase P shapes")
    c, i, wire_stats = run_gather_phases(nyx, dispatch, captured, "cuda")
    counts.update(c)
    inputs.update(i)
    counts["Q"], inputs["Q"], wire_stats["Q"], q_mean = run_exchange_phase(
        dispatch, captured, "cuda", args.seed)
    counts["Q.snap"] = run_snapshot_phase(q_mean, dispatch, "cuda", census)

    # the .ceazs stream engine and the file write: W, W.staged, W.bank,
    # W.fuzz
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        c, i, figs = run_stream_phases(nyx, fields["hacc"], dispatch,
                                       census, captured, card, tmp)
        counts.update(c)
        inputs.update(i)
        thr.update(figs)
        # the consumers of the stream: R, Q.stream, K, V
        c, i, consumers = run_consumer_phases(nyx, q_mean, dispatch, census,
                                              captured, card, tmp, args.seed)
        # the serving path: gemma3-1b saved, restored and served
        counts["SERVE"], inputs["SERVE"], serve = run_serve_phase(
            dispatch, census, captured, card, tmp, args.seed)
        # the MoE and MLA archs, the other attention archs' tables, then
        # the SSM archs
        walks, serve_new = {}, {}
        for phase, run_new in (("SERVE.MOE", run_moe_phase),
                               ("SERVE.ZOO", run_zoo_phase),
                               ("SERVE.SSM", run_ssm_phase)):
            c2, i2, serve_new[phase] = run_new(
                dispatch, census, captured, card, tmp, args.seed, walks)
            counts.update(c2)
            inputs.update(i2)
        # training: gemma3-1b trained, checkpointed and resumed
        counts["TRAIN"], inputs["TRAIN"], train = run_train_phase(
            dispatch, census, captured, card, tmp, args.seed, walks)
    counts.update(c)
    inputs.update(i)
    counts.update(dist_counts)         # TRAIN.DIST and SERVE.DIST
    del nyx, q_mean
    for p in [n for n, _, _ in GATHER_PHASES] + ["Q"]:
        check(all(op in inputs[p] for op in WIRE_OPS),
              f"pack/unpack inputs of phase {p} not captured")

    # the serving phases' restores leave tens of GB reserved by torch's
    # caching allocator: hand them back before the profiled kernel rows
    torch.cuda.empty_cache()
    print(f"chip_smoke phases: {time.perf_counter() - t_start:.1f} s; the "
          f"kernel rows follow")
    rows = kernel_rows(inputs)
    pack_rows(census.pack, rows)
    op_rows(census.op, rows)
    center_rows(census.center, rows)
    walk_rows(inputs, rows)
    walk_garbage_checks(inputs)
    staged_kernel_rows(inputs, census.flat, rows)
    window_checks(inputs, rows)
    serve_kernel_rows(inputs, rows)
    zoo_kernel_rows(walks, rows)
    nonfinite_check()
    center_corner_check()
    wire_kernel_rows(inputs, rows)
    wire_checks()
    for name, r in rows.items():
        r["launches"] = sum(c.get(name, 0) for c in counts.values())
        r["first_sight_holds"] = len(SIGHT.by_kernel.get(name, []))
    print(f"first-sight holds of the serving phases after SERVE (bitwise "
          f"against the plain versions), kernel -> [phase, wrapper, key]: "
          f"{SIGHT.by_kernel}; {SIGHT.seconds} s")
    # the censuses cover the parent's counted runs; phases TRAIN.DIST's
    # and SERVE.DIST's launches are their children's
    for name, cen in (("gather_pack_tiled", census.pack),
                      ("dq_center", census.center), ("hufenc", census.flat)):
        check(rows[name]["launches"]
              - sum(c.get(name, 0) for c in dist_counts.values())
              == sum(cen.totals().values()),
              f"{name} launched outside the phases its census covers")
    for name, t in thr.items():
        if "write_GBps" in t:
            continue                # a W phase: printed by stream_figures
        enc = (f"compress {t['compress_GBps']} GB/s ({t['compress_s']} s), "
               if "compress_s" in t else "")
        print(f"throughput phase {name} [{card}]: {enc}decompress "
              f"{t['decompress_GBps']} GB/s ({t['decompress_s']} s, "
              f"median of {t.get('decompress_samples', 3)}) of f32 input")
    thr["SERVE"] = serve
    thr.update(serve_new)
    thr["TRAIN"] = train
    thr["SERVE.DIST"] = dist_figs.pop("SERVE.DIST")
    thr["TRAIN.DIST"] = dist_figs
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"throughput": thr, "card": card}))
    print(json.dumps({"wire": wire_stats, "card": card}))
    print(json.dumps({"consumers": consumers, "card": card}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
