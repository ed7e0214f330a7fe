#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ICR on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --eager-step LABEL=SRC[:fpad] ...`` instead
times the eager dust fit step of the package under each SRC, one process
each, to compare two trees in one call: see ``eager_step_ab``;
``--mesh-step LABEL=SRC ...`` does so for phase 11b's warm sharded
gemma3-4b step on (2, 4) and (1, 16): see ``mesh_step_ab``;
``--tp-peaks LABEL=SRC ...`` gives phase 13's peak memory of the
sharded prefills and train step under each SRC: see ``tp_peaks_ab``;
``--kernels-once`` launches every kernel once at a small shape, the
program the sanitizers run: see ``kernels_once``; ``--level0-probe``
asks whether cuSOLVER's syevd, and the Cholesky root the port takes
instead, can be captured in a CUDA graph: see ``level0_probe``.)

Phases (any failure ends the run with a non-zero exit code):

1. build   — compile every CUDA kernel of the port from ``src/repro_torch``
   (one nvcc per source, in parallel); print the build time and the card,
   and (``ptxas`` line) the registers and spills of each instance of the
   streaming 1-D kernels (stationary and charted, forward and adjoint),
   the N-D kernel and the pyramid, with the shared memory of the N-D and
   pyramid launches and the blocks an SM holds.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes of every level of four charts (flagship dust
   ``galactic_dust_chart((8,16,16), 3)``, ``regular_chart(1024, 10)``,
   ``log_chart(1024, 8, n_csz=5, n_fsz=4)``, ``log_polar_chart((64,64),
   3)``), S=8 samples, real refinement matrices, in float32 (max relative
   error <= 1e-5) and with bfloat16 storage (<= 5e-2): the three forward
   kernels, the two noise-free forward kernels at every non-final pass the
   nd-axes route makes on the N-D levels, the pyramid at each chart's
   residency prefix (``dispatch.pyramid_prefix`` at S=8; ``pyramid_cover``
   keeps regular's alone; on the 1-D charts it must equal the per-level
   kernels bit for bit), the four adjoint kernels at every launch a
   level's backward makes (1-D levels; axis 0 and the trailing axes of N-D
   levels), and the charted forward at the nd-axes route's axis-0 pass of
   dust's last level in a learned-θ step (S=1: 16,384 rows of 16
   families).
3. path    — ``ICR(..., use_pallas=True).sample_batch(gen, 8)`` on each
   chart at both dtype policies, twice: with the pyramid (the default),
   which must launch once for its cover plus the per-level kernel once per
   uncovered level, and with ``use_pyramid=False``, every level on its
   per-level kernel; each held against the same apply through the plain
   versions on the card, the launch counters zeroed just before.
4. train   — training on the kernel route, float32, each path with the
   launch counters zeroed just before and read just after: ``dust`` 20
   ``map_fit`` and 10 ``advi_fit`` steps (n_mc=2) on ``charted_gp_dataset``
   (obs_frac 0.3, noise 0.05); ``regular``, ``dust_theta`` and
   ``log_polar_theta`` 10 joint (ξ, ρ) MAP steps under a lognormal prior,
   the matrices rebuilt in every step (the N-D ones through the pyramid's
   replay over the nd-axes route); ``log`` and ``log_polar`` 10 MAP steps
   at fixed θ. Losses must fall and every kernel the path reaches must
   have launched. Then, per path, one step's gradient through the kernels
   against the same through the plain versions (ξ <= 1e-5; on the
   learned-θ paths the matrix cotangents <= 1e-4 and dρ reported, see
   ``theta_gradient``), and ``ICR.apply_sqrt_T_batch`` on the kernels
   against autograd of the plain apply at both policies. The fixed-θ
   fits, fixed θ and learned θ alike, run compiled (``jit=True``: one
   captured CUDA graph per step, replayed; a learned-θ step rebuilds its
   matrices inside the graph). Before the fits, the eigensolver of the
   matrix build (``kernels/sym_eig.py``) against its plain version at the
   largest batch each learned-θ path's build hands it and at log's 65,536
   4x4 D's (``eig_cases``; bit for bit, <= 1e-6 relative, status under
   its bound): one ``sym_eig`` line.
4b. graphs — the compiled paths against the same code run op by op on
   the card, bit for bit: ``map_fit(jit=True)`` against ``jit=False`` on
   dust, log and log_polar (10 steps, losses and ξ̂), dust's ADVI fit
   against its eager twin from the same generator state,
   ``apply_sqrt_T_batch`` (a replay of its cached graph) against its chain
   op by op on the four charts at S = 1 and 8 and both policies (and
   against autograd of the plain apply at the tolerances above), and the
   learned-θ fits: ``map_fit(jit=True)`` against ``jit=False`` on
   regular, dust_theta and log_polar_theta at full width (10 steps;
   losses, ξ̂ and ρ's latent) and a learned-θ ``advi_fit`` on regular (one
   matrix build per draw) against its eager twin; every capture holds its
   kernel nodes to its wrappers' launches and their launch plans
   (``core/graphs.capture``). One ``graphs`` line.
5. serve   — ``GPFieldServer(demo_posterior(...), slab=8)`` on each
   chart at both dtype policies serves ``mixed_requests(3, 16)`` cold,
   then warm, the launch counters zeroed just before and read just after
   (every kernel of the chart's plan must have launched). Each slab is
   one replay of a captured CUDA graph whose kernel nodes, counted by
   name at capture, equal the plan's launches kernel for kernel (each
   replay adds those counts); checked: the graph's slab equals
   the eager kernel route on the same ξ bit for bit (and that route its
   plain version, at the tolerances above), warm traffic captures no
   graph and rebuilds no matrices and no plan, the card's integer noise
   stream equals the CPU's, every field is finite and every moments std
   positive. The ``serve`` line gives per chart and dtype the slab's
   milliseconds replayed and eager (CUDA events after the flush), the
   host milliseconds to enqueue each, the draw's and the device-to-host
   copy's milliseconds, the host milliseconds of one numpy Welford merge
   of a whole slab, cold and warm milliseconds, rows per second, the
   modeled slab bytes (``plan()``'s ``hbm_bytes``) and their bound at the
   card's bandwidth, the draw's floor bytes (``draw_floor_bytes``) and
   bound, the bound of the whole slab (levels, draw and the f32 cast),
   and the card's name and power limit.
6. condition — the data-conditioned solve on the four charts at full
   width, float32, one ``condition`` line per chart, the launch counters
   zeroed just before each driven path and read just after (every kernel
   of the forward's plan and of its adjoint must have launched):
   (a) ``cg_posterior`` with 4,096 seeded on-grid observations of a prior
   draw, σ = 0.25, at its default config (rtol 1e-7, the bar rising to
   the float32 matvec's rounding δ at each column's own iterate, capped
   at ``floor_cap``; the report stating rtol, the cap and δ): rungs,
   iterations, status, the reported relres, the preconditioner's bytes
   and the solve's wall ms; matvec milliseconds by CUDA events at k = 1
   and 17 and the host time to enqueue one; checked: status
   ``converged`` or ``dense``, and the residual ‖y − A α‖/‖y‖ of the
   solve's own α (``cg_posterior``'s ``_solution``) recomputed through
   the plain versions at float64 on the solve's own matrices
   (``residuals64``, ``same``) within 10·max(rtol, min(δ, cap)) < 1, δ
   the rounding of one float32 kernel-route matvec at α; the residual on
   matrices built
   at float64 is printed beside it; then the same solve at the JAX
   package's rtol 1e-7 (``cond_tight``: the CG rungs stall, the dense
   rung answers); both solves again with their CG segments replayed from
   captured graphs and run op by op, equal bit for bit in status,
   iterations and α (``graph_vs_eager``), and one CG iteration's
   milliseconds and a segment's enqueue each way at k = 1 and 17
   (``cg_iteration_ms``); (b)
   ``condition_matvec`` on the kernels against the plain route
   (``plain_matvec``) at k = 17, <= 1e-5 at f32 and <= 5e-2 with bf16
   storage; on dust and regular, (c) one served ``kind="condition"``
   request (n = 16) at rtol 1e-7: its mean and (a)'s at rtol 1e-7
   against each other and against the float64 posterior mean of the same
   system (``mean64``) within ``COND_MEAN_F64``, its std finite, its
   ``SolveReport`` in ``metrics()``; (e) on ``charted_gp_dataset``'s
   pattern (30 %, σ = 0.05: 314,572 observations) ``cg_posterior`` and a
   served request at their default configs must answer, α's float64
   residual within 10·max(rtol, min(δ, cap)) < 1, with the device bytes
   of the preconditioner and of the server's cached system beside it;
   each line ends with the bytes the card still holds once the chart's
   systems are dropped; (d) on that pattern the ICR rung at
   the level-0 basis (the default system's preconditioner) against the
   unpreconditioned rung (500 iterations): iterations, status and the
   float64 residual of each; a rung that reports ``converged`` above
   10·rtol on its own matrices fails the run.
7. distributed — a mesh of 8 slots over the visible cards (one card
   repeated: a virtual mesh; the line gives the distinct devices):
   ``DistributedICR.apply_sqrt_batch`` at S = 8, f32 and bf16, on dust
   (shard axis 1), regular, log_polar and a reflect twin of the log chart
   (``log_chart(1024, 8, n_csz=5, n_fsz=4, delta0=0.0197/16,
   boundary="reflect")``, 262,144 points; the script's log chart is
   "shrink", which DistributedICR refuses), each against the unsharded
   kernel route (<= 1e-5 at f32, <= 5e-2 with bf16; bits equal or not),
   its launches (each sharded level's kernel once per slot, a replicated
   level once per device, and no plain version called), device ms
   sharded and unsharded (CUDA events after the flush), enqueue ms, and
   the halo bytes per sharded level; ``mixed_requests(3, 16)`` served on
   dust and regular in samples mode (slab 2 a slot, one graph per slot)
   bit for bit against the unsharded server, in chart mode within 1e-5,
   and in samples mode with a ``KillDevice`` at the second slab attempt
   (one re-plan, one cache miss, the replay bit for bit); and
   ``cg_posterior(mesh=)`` on dust at 4,096 observations, σ = 0.25: α
   against the unsharded solve's within 10·max(rtol, δ), the mean within
   ``COND_MEAN_F64`` of the float64 posterior mean. One ``distributed``
   line.
7b. analysis — the launch plans (``kernels/launch.py``) and the
   static-analysis layer (``repro_torch.analysis``) on the card: the
   verifier (coverage, bounds, halo, bytes, hygiene) over every level of
   the four charts at full width, S = 8, f32 and bf16 (one process a
   scenario) and over the distinct plans phase 7's runs launched through,
   then its transpose pass on the kernels (S = 2; 1e-5 at f32, 5e-2 with
   bf16); every kernel node of every graph the run captured (the slab,
   the fixed-θ fit step, the transpose, the CG segment) against the plan
   it was launched through, grid, block and shared memory (``plan_ties``,
   with the pyramid's co-resident grid on the card beside the H100 model);
   each of the ten kernels and the eigensolver once at a full-width shape
   into NaN-filled outputs with guard bands (``witness``: no NaN inside,
   the guards still NaN, the plain version's result); ``compute-sanitizer`` memcheck and
   racecheck over ``--kernels-once`` where the toolkit has the tool (its
   absence, or a run without a summary, is recorded; a reported error
   fails the run); the lint with ``ptxas``' registers; the profiler
   roofline (``roofline/analysis.py``) of the apply, the VJP and the slab
   on the four charts; and one learned-θ step's matrix build split into
   the level-0 root, the per-level builds and the backward of each, op by
   op and as graph replays (``theta_split``). Lines ``sanitizer``, ``verify``, ``plan_ties``,
   ``witness``, ``lint``, ``roofline``, ``theta_split``.
8. times   — per kernel at its chart's largest level (the pyramid at
   regular's cover, the one ``ICR`` runs, and at the dust prefix, with the
   per-level kernels it replaces beside it):
   CUDA-event medians of the kernel, its plain version and, where one
   PyTorch call computes (part of) the same function, that call
   (``F.conv1d``, ``F.conv_transpose1d`` or an einsum over a strided view
   of the coarse rows); a device copy of as many bytes (``copy_ms``: what
   this timing gives a kernel that only moves its bytes); #7 also at the
   N-D backward's axis-0 shape (dust's last level), #3 at the nd-axes
   route's axis-0 shape (``shape.nd_axes``); the
   byte/operation bound; whole-path milliseconds per chart with the
   pyramid on and off; per level of each chart at float32, the torch glue
   against the kernels, forward and backward, and ``apply_sqrt_T_batch``
   replayed and op by op with the host enqueue of each; and one training
   step's milliseconds (forward, backward and update) per path, with its
   host enqueue time, op by op and as one graph replay; the eigensolver at
   each ``eig_cases`` batch against its plain version and
   ``torch.linalg.eigh`` (its line in ``kernels`` carries them under
   ``per_batch``, headed by log_polar_theta's).

9. lm      — LM serving (``repro_torch.models``, ``launch/serve.py``;
   plain torch ops, no kernel of the port), with float32 GEMM
   accumulation throughout (TF32 off, no reduced-precision split-K): the
   ten reduced architectures at float32, each with ``prefill_fn`` and 16
   steps of ``BatchedServer``'s captured decode step on the card against
   the same model and parameters on the CPU (<= 1e-4 of the largest
   |logit|), the middle step against ``Model.serve_step`` op by op from
   the same cache (logits and cache bit for bit), and decode against
   teacher forcing (argmax equal, normalized logits within 5e-2; one
   ``lm_reduced`` line); then gemma3-4b at full width and depth (34
   layers, 3.88 B parameters, bfloat16) drawn from a seeded generator on
   the card and served by ``BatchedServer`` with 4 slots and s_max 2048:
   one step with every slot live, graph against eager bit for bit; the
   step's ms replayed and op by op (CUDA events after a flush), the host
   enqueue of each, its kernels under ``torch.profiler``, the logits'
   device-to-host ms, decode tok/s at 4 slots, ``prefill_fn`` ms for
   1,100 tokens, the weight-read and cache-read bounds at the card's
   bandwidth; 8 seeded requests (prompts of 16-1,200 tokens, two past
   the 1,024 window, so the local layers' ring buffers wrap; 32 new
   tokens each) served to the end with the token accounting checked; and
   1,100 tokens decoded one by one against ``prefill_fn`` (argmax equal,
   normalized logits within 5e-2): in bfloat16, and where bfloat16
   misses, the same weights widened to float32, which must meet it (the
   bfloat16 figure is recorded, with each dtype's gap after 1, 16 and 128
   tokens against the prefill of that prefix). One ``lm_serve`` line.

10. lm_train — LM training (the models' backward with remat, ``optim/``,
   ``launch/steps.py``, ``launch/train.py``, ``data/pipeline.py``; plain
   torch ops, none of the port's kernels): (a) the ten reduced
   architectures at float32, 4 rows × 32 tokens of ``SyntheticLMData``:
   the loss and every gradient leaf on the card against the CPU (<= 1e-4
   of the leaf's largest entry; a leaf zero in exact arithmetic, whisper's
   key biases, within 1e-6 of the largest entry of all), ``remat=True``
   against off on the card (<= 1e-6), one step of sgd (momentum 0.9),
   adamw and adafactor from the CPU's gradients on both (<= 1e-6), an
   ``accum = 2`` SGD train step on both (<= 1e-4), and first, on the MoE
   architectures, the top-k routes on both (equal, with their smallest
   margin); one ``lm_train_reduced`` line. (b) gemma3-4b at full width
   and depth, bf16, remat, ``train_4k``'s 4,096 tokens at global batch 2
   (the cell's 256 cut to one card's time): one forward and backward with
   the stacked group leaves' rows taken by ``x[g]`` (the code) and by
   ``unbind``, twice each in turns (peak memory and s each); the bf16
   gradients of the tied table, the first group's rows, the last tail
   layer and the final norm against the same from a float32 copy of the
   weights (cosine >= 0.99, relative error per leaf); ``train_loop`` for
   8 steps (AdamW from ``select_optimizer``): finite losses, step 0's
   batch lower after the last step, step ms by CUDA events (median of
   steps 3–8), enqueue ms, tokens/s, MFU (6·N·D over the step and 989
   TFLOP/s), peak memory allocated and reserved; one more step under
   ``torch.profiler`` and one under CUDA's sync debug mode. (c) the
   ``fail_at`` drill (one restart, the unfailed run's parameters and
   optimizer state bit for bit) and a resume from a checkpoint (the
   uninterrupted run's losses and parameters bit for bit) on reduced
   starcoder2 on the card. One ``lm_train`` line.

11. lm_shard — the sharded LM executor (``distributed/sharding.py``,
   ``distributed/executor.py``, ``distributed/compression.py``, the mesh
   branches of ``models/``, ``launch/steps.py`` and ``launch/train.py`` on
   a mesh; plain torch ops, none of the port's kernels), on virtual
   meshes of slots of the one card, every batch placed per line (each
   data index's rows on its own slots) through
   ``make_batch_iterator(shardings=)`` and the step's
   ``batch_shardings``: (a) the ten reduced architectures at
   float32 on (data 2, model 2) ("head", the kv heads split), (1, 4)
   ("head", the kv heads repeated), (1, 8) ("key") and (4, 1) (one row
   per line, the last row's labels partly masked): the loss and every
   gradient leaf against the card's one-slot step (<= 1e-5 of the leaf's
   largest entry), one update of sgd, adamw and adafactor (factored) from
   the one-slot gradients placed on (2, 2) and (1, 8) (<= 1e-5), an
   accum-2 SGD step on (2, 2) (<= 1e-5), the collective counts of each
   mesh; one ``lm_shard_reduced`` line; ``compressed_psum`` on 8 slots
   within the JAX package's test bounds. (b) gemma3-4b at full width and
   depth, bf16, remat, AdamW at a constant 3e-4, phase 10's parameters
   and 2 × 4,096-token batch on (2, 4): one sharded step against the
   one-slot step: loss within 1e-3, gradient cosine >= 0.999 over all
   leaves and >= 0.99 leaf by leaf, and the sharded step's own updated
   parameters against the one-slot step's, leaf by leaf, within 5e-2·lr
   plus one bf16 rounding, on the entries whose two gradients agree
   within 2^-6 (a near-zero gradient's sign noise turns AdamW's first
   update into a full-size difference; at least a quarter of the entries
   must be held); the sharded step's gradients and update each timed by
   CUDA events with their host enqueue, then one more whole step timed
   (warm), the peak memory allocated (beside phase 11b's 57.7–70.5 GB
   before the lines, PERF.md) and the step's collective calls
   and bytes; then one whole sharded step on (1, 16), the production
   model axis ("key"), timed, its loss held to the one-slot loss.
   (c) on reduced starcoder2, SGD: the loop on (2, 2)
   against the one-slot loop, the ``fail_at`` drill on (2, 2) (the
   uninterrupted run's parameters bit for bit) and a resume from a
   checkpoint onto (1, 2), the survivors of ``shrink_mesh`` (<= 1e-5).
   One ``lm_shard`` line.
12. dryrun — the dry run (``configs.input_specs``, ``make_prefill_step``
   and ``make_serve_step`` on a mesh, ``roofline/op_cost.py``,
   ``roofline/analysis.py``'s roofline terms, ``launch/dryrun.py``): (a)
   the H100 constants of ``launch/mesh.py`` beside the card's own memory
   and name (``constants`` line); (b) gemma3-4b's one-slot train step at
   phase 10's batch counted on ``meta`` (FLOPs; predicted peak: the
   parameters and optimizer state plus the counter's peak of the step)
   against the same step run on the card under the same counter: FLOPs
   equal exactly, the peak within ``DRY_PEAK_TOL`` of
   ``max_memory_allocated`` (``dryrun_one_slot`` line); (c) gemma3-4b at
   full width, bf16, on (2, 4) ("head") and (1, 16) ("key", the cache's
   sequence split), every batch placed per line: a prefill of two
   prompts of 1,100 tokens (one per line of (2, 4)) against one slot;
   phase
   9's 8 requests teacher forced (s_max 2048) through the one-slot step
   at positions 0..123, then 8 steps at positions 124..131 on the mesh
   and on one slot, crossing the first boundary of the key blocks (128
   positions each), logits within 5e-2, decode argmax equal at every
   row and step, the cache gathered after them within 5e-2 of the
   one-slot cache, and the executor's collective counts equal to the
   same steps' on a mesh of ``meta`` slots (``dryrun_mesh`` line); (f)
   one train step of reduced deepseek-v2 on (2, 4) under the op counter
   on the card and on ``meta``: FLOPs equal, each owner's peak within
   ``DRY_PEAK_TOL`` (``dryrun_mesh_train`` line); (d)
   the launches and halo bytes of phase 7's sharded dust and log-twin
   applies against ``dryrun.icr_geometry``; (e) the dry run's rows of
   gemma3-4b's decode_32k cell and icr-dust-pod on the 16x16 mesh, each
   a process of its own on one CPU core, started after (d), when the
   card is done. One ``dryrun`` line.
13. lm_tp  — the tensor-parallel forms of the mixers that earlier ran
   replicated on a mesh (MLA's heads around its latents, Mamba2's heads
   or channels, mLSTM's heads or q·k dim, sLSTM's projections, the MoE
   router's columns, the stub frontends; plain torch ops, none of the
   port's kernels), on virtual meshes of the card, seeded weights, 12c's
   checks (``dry_mesh_case``) in bf16 and again in float32 (the same
   weights widened): (a) zamba2-7b at full width and depth (81 layers,
   4.6 B parameters) on (2, 4), two prompts of 1,024 tokens prefilled (a
   line each), two requests written by the one-slot step at positions
   0..15 and 8 decode steps (bf16: 2) on the mesh and on one slot; and
   on (1, 16) (7 of its 112 heads a slot in the prefill; the state's 64
   channels 4 a slot in decode), one prompt of 256 tokens and 4 steps
   (bf16: 2);
   (b) deepseek-v2 at full width cut to its leading dense layer and two
   MoE layers (9.3 B parameters) on (2, 4), as (a) with 8 decode steps
   in both dtypes, the bf16 steps' collective counts equal to the same
   steps' on ``meta`` slots; (c)
   xlstm-1.3b at full width and depth, one AdamW step on (2, 4) at 2 ×
   64 tokens against the one-slot step (phase 11b's ``lms_full``), the
   sharded step's ms and peak memory. The float32 runs hold the forms to
   one slot (logits, decode and the cache within 1e-3, argmax equal;
   xlstm's loss within 1e-3 and its gradient cosine >= 0.999 over all
   leaves and >= 0.99 leaf by leaf). The bf16 runs must be finite and
   their prefill no farther from the float32 one-slot logits than twice
   one slot's bf16 prefill is: at these depths bf16's own rounding moves
   the seeded models' logits by tens of percent (``bf16_one_vs_f32``),
   and xlstm's bf16 gradients' cosine to one slot's is given beside one
   slot's bf16 gradients' cosine to its float32 ones. One ``lm_tp``
   line.

The last three lines are the ``kernels`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.

Relative error is ``max|kernel - plain| / max|plain|``. Float32 matmuls
and convolutions run without TF32 throughout.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
S = 8                        # samples per apply (the serving slab)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
REPS = 25                    # timed repetitions after warm-up
# the card's peaks and bandwidths: repro_torch.launch.mesh (imported in
# the functions: this module imports nothing of the repo at its top)

FWD_SRC = "src/repro_torch/kernels/csrc/refine_1d.cu"
ADJ_SRC = "src/repro_torch/kernels/csrc/refine_1d_adjoint.cu"
# per kernel: its source, the TPU kernel it replaces, and the chart (and
# level axis, for the noise-free passes and the trailing-axis adjoints)
# whose largest level it is timed at
KERNEL_INFO = {
    "refine_stationary": {
        "source": FWD_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:98",
        "replaces_fn": "_stationary_kernel",
        "chart": "regular"},
    "refine_stationary_nn": {
        "source": FWD_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:115",
        "replaces_fn": "_stationary_nn_kernel",
        "chart": "dust", "axis": 1},
    "refine_charted": {
        "source": FWD_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:129",
        "replaces_fn": "_charted_kernel",
        "chart": "log"},
    "refine_charted_nn": {
        "source": FWD_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:145",
        "replaces_fn": "_charted_nn_kernel",
        "chart": "log_polar", "axis": 1},
    "refine_stationary_adjoint": {
        "source": ADJ_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:184",
        "replaces_fn": "_stationary_adjoint_kernel",
        "chart": "regular"},
    "refine_stationary_adjoint_nn": {
        "source": ADJ_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:204",
        "replaces_fn": "_stationary_adjoint_nn_kernel",
        "chart": "dust"},
    "refine_charted_adjoint": {
        "source": ADJ_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:220",
        "replaces_fn": "_charted_adjoint_kernel",
        "chart": "log"},
    "refine_charted_adjoint_nn": {
        "source": ADJ_SRC,
        "replaces": "src/repro/kernels/icr_refine.py:242",
        "replaces_fn": "_charted_adjoint_nn_kernel",
        "chart": "log_polar"},
    "refine_nd_fused": {
        "source": "src/repro_torch/kernels/csrc/nd_fused.cu",
        "replaces": "src/repro/kernels/nd_fused.py:119",
        "replaces_fn": "_nd_fused_kernel",
        "chart": "dust"},
    "refine_pyramid": {
        "source": "src/repro_torch/kernels/csrc/pyramid.cu",
        "replaces": "src/repro/kernels/pyramid.py:150",
        "replaces_fn": "_pyramid_kernel",
        "chart": "regular"},
}
# the port's kernel with no TPU counterpart: the batched Jacobi of the
# matrix build, which XLA's eigh is inside the TPU's compiled step
EIG = "sym_eig"
EIG_INFO = {"source": "src/repro_torch/kernels/csrc/sym_eig.cu",
            "replaces": "src/repro/core/refine.py:61",
            "replaces_fn": "jnp.linalg.eigh (XLA's Jacobi in the compiled "
                           "step; no Pallas kernel)"}
# the launch counters the phases read: the ten kernels and the eigensolver
COUNTED = tuple(KERNEL_INFO) + (EIG,)
FORWARD = ("refine_stationary", "refine_charted", "refine_nd_fused")
NOISE_FREE = ("refine_stationary_nn", "refine_charted_nn")
PYRAMID = "refine_pyramid"
ADJOINT = tuple(k for k in KERNEL_INFO
                if k not in FORWARD + NOISE_FREE + (PYRAMID,))
# the kernels each training path must reach: regular (learned θ) through
# the pyramid's forward and its replay over the 1-D kernels; the charts
# the pyramid does not cover (dispatch.pyramid_cover: N-D and charted 1-D)
# through their per-level kernels and the adjoints, the learned-θ N-D
# paths through the nd-axes route; every learned-θ path through the
# eigensolver of its matrix build
TRAIN_REACHES = {
    "dust": ("refine_nd_fused", "refine_charted_adjoint",
             "refine_stationary_adjoint_nn"),
    "regular": (PYRAMID, "refine_stationary", "refine_stationary_adjoint",
                EIG),
    "log": ("refine_charted", "refine_charted_adjoint"),
    "log_polar": ("refine_nd_fused", "refine_charted_adjoint",
                  "refine_charted_adjoint_nn"),
    "dust_theta": ("refine_charted", "refine_stationary_nn",
                   "refine_charted_adjoint", "refine_stationary_adjoint_nn",
                   EIG),
    "log_polar_theta": ("refine_charted", "refine_charted_nn",
                        "refine_charted_adjoint",
                        "refine_charted_adjoint_nn", EIG),
}
NOISE = 0.05                 # observation noise of the training data
OBS_FRAC = 0.3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def charts():
    from repro_torch import (galactic_dust_chart, log_chart, log_polar_chart,
                             matern32, regular_chart)

    return {
        "dust": (galactic_dust_chart((8, 16, 16), 3),
                 matern32.with_defaults(rho=0.5)),
        "regular": (regular_chart(1024, 10, boundary="reflect"),
                    matern32.with_defaults(rho=5000.0)),
        "log": (log_chart(1024, 8, n_csz=5, n_fsz=4, delta0=0.0197 / 16),
                matern32.with_defaults(rho=1.0)),
        "log_polar": (log_polar_chart((64, 64), 3),
                      matern32.with_defaults(rho=2.0)),
    }


def rel_err(got, ref) -> tuple:
    diff = float((got.float() - ref.float()).abs().max())
    return diff, diff / max(float(ref.float().abs().max()), 1e-30)


def level_inputs(icr, mats, lvl, dtype, gen):
    """Seeded coarse field and ξ of level `lvl`, plus its matrices."""
    import torch

    from repro_torch.core.refine import LevelGeom

    geom = LevelGeom.for_level(icr.chart, lvl)
    field = torch.randn((S,) + geom.coarse_shape, generator=gen,
                        device="cuda").to(dtype)
    xi = torch.randn((S,) + icr.xi_shapes()[lvl + 1], generator=gen,
                     device="cuda").to(dtype)
    axis_mats = ((mats["Rax"][lvl], mats["sqrtDax"][lvl])
                 if "Rax" in mats else None)
    r = mats["R"][lvl] if "R" in mats else None
    d = mats["sqrtD"][lvl] if "sqrtD" in mats else None
    return geom, field, xi, r, d, axis_mats


def adjoint_ops():
    """name -> (kernel wrapper, plain version) of the adjoint kernels."""
    from repro_torch.kernels import icr_refine as ir

    return {
        "refine_stationary_adjoint": (ir.refine_stationary_adjoint,
                                      ir.refine_stationary_adjoint_plain),
        "refine_stationary_adjoint_nn": (ir.refine_stationary_adjoint,
                                         ir.refine_stationary_adjoint_plain),
        "refine_charted_adjoint": (ir.refine_charted_adjoint,
                                   ir.refine_charted_adjoint_plain),
        "refine_charted_adjoint_nn": (ir.refine_charted_adjoint,
                                      ir.refine_charted_adjoint_plain),
    }


def adjoint_cases(icr, mats, lvl, dtype, gen):
    """Every adjoint launch of level `lvl`'s backward at S samples, with a
    seeded cotangent: ``[(kernel name, g, r, d or None, coarse_len)]``.
    1-D levels make one launch; N-D levels one on axis 0 with noise and one
    per trailing axis without, over the other axes' padded or fine
    extents (``nd_fused.refine_nd_fused_adjoint``)."""
    import torch

    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch

    chart = icr.chart
    geom = LevelGeom.for_level(chart, lvl)
    fsz, csz, t = geom.n_fsz, geom.n_csz, geom.T
    padded = [n + 2 * geom.b if geom.boundary == "reflect" else n
              for n in geom.coarse_shape]
    if chart.ndim == 1:
        charted = (dispatch.route_for(geom) == dispatch.ROUTE_CHARTED_1D)
        lead = (t[0],) if charted else ()
        axes = [(charted, S, 0, mats["R"][lvl].reshape(lead + (fsz, csz)),
                 mats["sqrtD"][lvl].reshape(lead + (fsz, fsz)))]
    else:
        rs, ds = mats["Rax"][lvl], mats["sqrtDax"][lvl]
        fine = [n * fsz for n in t]
        axes = [(rs[0].ndim == 3, S * math.prod(fine[1:]), 0, rs[0], ds[0])]
        axes += [(rs[a].ndim == 3,
                  S * math.prod(padded[:a]) * math.prod(fine[a + 1:]), a,
                  rs[a], None) for a in range(1, chart.ndim)]
    out = []
    for charted, rows, a, r, d in axes:
        name = (("refine_charted_adjoint" if charted
                 else "refine_stationary_adjoint")
                + ("" if d is not None else "_nn"))
        g = torch.randn((rows, t[a] * fsz), generator=gen,
                        device="cuda").to(dtype)
        out.append((name, g, r.to(dtype).contiguous(),
                    None if d is None else d.to(dtype).contiguous(),
                    padded[a]))
    return out


def nn_cases(icr, mats, lvl, dtype, gen):
    """Every noise-free pass the nd-axes route makes on N-D level `lvl`
    (axes d-1..1, before axis 0's pass with noise) at S samples, with a
    seeded coarse input of that pass's shape: ``[(kernel name, coarse, r,
    families, axis)]``. The rows of axis a's pass are the samples times the
    other axes: coarse extents before a, fine extents after it."""
    import torch

    from repro_torch.core.refine import LevelGeom

    geom = LevelGeom.for_level(icr.chart, lvl)
    fsz, t = geom.n_fsz, geom.T
    b = geom.b if geom.boundary == "reflect" else 0
    out = []
    for a in range(icr.chart.ndim - 1, 0, -1):
        r = mats["Rax"][lvl][a].to(dtype).contiguous()
        rows = (S * math.prod(geom.coarse_shape[:a])
                * math.prod(n * fsz for n in t[a + 1:]))
        coarse = torch.randn((rows, geom.coarse_shape[a] + 2 * b),
                             generator=gen, device="cuda").to(dtype)
        name = "refine_charted_nn" if r.ndim == 3 else "refine_stationary_nn"
        out.append((name, coarse, r, t[a], a))
    return out


def nn_ops():
    """name -> (kernel wrapper, plain version) of the noise-free kernels,
    each called as f(coarse, r, families)."""
    from repro_torch.kernels import icr_refine as ir

    return {
        "refine_stationary_nn": (ir.refine_stationary_nn,
                                 ir.refine_stationary_nn_plain),
        "refine_charted_nn": (lambda c, r, t: ir.refine_charted_nn(c, r),
                              lambda c, r, t: ir.refine_charted_nn_plain(
                                  c, r)),
    }


def pyramid_case(icr, mats, dtype, gen, samples=S):
    """The pyramid's operands at the chart's residency prefix
    (``dispatch.pyramid_prefix``: the levels the kernel can take, whether
    or not ``pyramid_cover`` keeps them) for `samples` samples of `dtype`
    (seeded field and ξ): ``(geoms, field, levels)``, or None when the
    chart has no prefix."""
    import torch

    from repro_torch.core.icr import _pyramid_mats
    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch, pyramid

    k = dispatch.pyramid_prefix(icr.chart, samples=samples,
                                itemsize=dtype.itemsize)
    if k is None:
        return None
    geoms = [LevelGeom.for_level(icr.chart, lvl) for lvl in range(k)]
    field = torch.randn((samples,) + geoms[0].coarse_shape, generator=gen,
                        device="cuda").to(dtype)
    xis = [torch.randn((samples,) + icr.xi_shapes()[lvl + 1], generator=gen,
                       device="cuda").to(dtype) for lvl in range(k)]
    pm = [_pyramid_mats(mats, g, lvl) for lvl, g in enumerate(geoms)]
    pm = [([r.to(dtype) for r in rs], [d.to(dtype) for d in ds])
          for rs, ds in pm]
    field, levels = pyramid.pyramid_operands(field, xis, pm, geoms,
                                             sample_axis=True)
    return geoms, field, levels


def plain_apply(icr, mats, xi):
    """``icr.apply_sqrt_batch`` with every kernel replaced by its plain
    version, on the same device (differentiable by plain autograd)."""
    import torch

    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch

    pol = icr.policy if icr.dtype_policy is not None else None
    field = torch.matmul(xi[0], mats["sqrt0"].T).reshape(
        (xi[0].shape[0],) + icr.chart.shape0)
    if pol is not None:
        field = field.to(pol.storage_dtype)
    for lvl in range(icr.chart.n_levels):
        geom = LevelGeom.for_level(icr.chart, lvl)
        axis_mats = ((mats["Rax"][lvl], mats["sqrtDax"][lvl])
                     if "Rax" in mats else None)
        r = mats["R"][lvl] if "R" in mats else None
        d = mats["sqrtD"][lvl] if "sqrtD" in mats else None
        route, args = dispatch.level_operands(
            field, xi[lvl + 1], r, d, geom, axis_mats=axis_mats,
            sample_axis=True)
        field = dispatch.PLAIN[route](*args).reshape(
            (field.shape[0],) + tuple(geom.fine_shape))
    return field


def time_ms(fn, flush) -> float:
    """Median milliseconds of `fn` by CUDA events, L2 flushed before each
    repetition. The flush (a 2 GiB memset, ~0.64 ms on the card) also
    keeps the card busy while the host enqueues `fn`, so the events time
    the device work and not the host's launch overhead, unless `fn` takes
    the host longer than that to enqueue (``enqueue_ms``; the pyramid's
    wrapper takes 0.1-0.3 ms, more than a 512 MB memset hid)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def enqueue_ms(fn) -> float:
    """Median host milliseconds to enqueue `fn` on an idle card: where it
    is near `fn`'s device time, the card waits on the host."""
    return enqueue_spread(fn)["median"]


def enqueue_spread(fn) -> dict:
    """Median, min and max host milliseconds to enqueue `fn` on an idle
    card, over ``REPS`` calls."""
    import torch

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def host_ms_per_call(fn, calls: int = 200, blocks: int = 5) -> float:
    """Median over `blocks` of the host milliseconds per call of `calls`
    back-to-back calls of `fn` (the card synced between blocks): the host
    cost of a call where the card keeps up, with less jitter than one
    enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def operand_bytes(route, args, out) -> int:
    """Bytes a kernel must move: each operand read once, the output
    written once."""
    tensors = [out, *args] if route != "nd-fused" else [
        out, *args[:4], *args[4]]
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_fmas(route, args) -> int:
    """Multiply-adds the function needs on these operands."""
    if route != "nd-fused":
        _, xi, r, _ = args
        n_fsz, n_csz = r.shape[-2:]
        return xi.numel() * (n_csz + n_fsz)
    field, xi0, r0, _, _, T = args
    fsz, csz = r0.shape[-2:]
    s = fsz // 2
    nd = field.ndim - 1
    ext = [(T[a] - 1) * s + csz for a in range(nd)]   # coarse rows read
    fmas = 0
    for a in range(nd - 1, 0, -1):                     # trailing stages
        n = field.shape[0] * csz
        for b in range(nd):
            n *= T[b] * fsz if b > a else (T[a] * fsz if b == a else ext[b])
        fmas += n
    return fmas + xi0.numel() * (csz + fsz)            # axis 0 + noise


def adjoint_cost(g, r, d, outs) -> tuple:
    """(bytes, multiply-adds) of one adjoint launch: g and the matrices
    read once, dcoarse (and dxi) written once; per family ``n_fsz·n_csz``
    multiply-adds for the overlap-add and ``n_fsz²`` for dxi."""
    n_fsz, n_csz = r.shape[-2:]
    moved = sum(t.numel() * t.element_size()
                for t in (g, r, *outs) + ((d,) if d is not None else ()))
    fam = g.numel() // n_fsz
    return moved, fam * (n_fsz * n_csz + (n_fsz * n_fsz if d is not None
                                          else 0))


WINDOW_EINSUM = ('torch.einsum("tfc,btc->btf", R, '
                 'coarse.unfold(1, n_csz, n_fsz//2))')


def window_einsum(coarse, r, t):
    """The charted window contraction as one PyTorch call over a strided
    view of the coarse rows: the charted kernels' library yardstick."""
    import torch

    n_fsz, n_csz = r.shape[-2:]
    win = coarse.unfold(1, n_csz, n_fsz // 2)[:, :t]
    return torch.einsum("tfc,btc->btf", r, win)


def main_path_smem(models) -> dict:
    """Dynamic shared memory (bytes) of the N-D and pyramid launches at
    S=8: nd_fused at dust's last level, the pyramid at the dust prefix (its
    N-D instance); its 1-D levels stream without shared memory."""
    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import dispatch, nd_fused

    def nd_smem(geom, charted):
        tile = nd_fused.nd_tile(tuple(geom.T), geom.n_csz, geom.n_fsz,
                                charted, S)
        return 4 * nd_fused._smem_floats(tile, tuple(geom.T), len(geom.T),
                                         geom.n_csz, geom.n_fsz, charted)

    dust = models["dust"][0].chart
    charted = tuple(not k for k in dust.invariant)
    k = dispatch.pyramid_prefix(dust, samples=S) or 1
    geoms = [LevelGeom.for_level(dust, lvl) for lvl in range(k)]
    return {"nd_fused": nd_smem(LevelGeom.for_level(dust, dust.n_levels - 1),
                                charted),
            "pyramid nd": max(nd_smem(g, charted) for g in geoms),
            "pyramid 1d": 0}


def bound(moved, fmas, bandwidth) -> tuple:
    from repro_torch.launch.mesh import PEAK_FLOPS_F32

    t_bytes = moved / bandwidth * 1e3
    t_ops = 2 * fmas / PEAK_FLOPS_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def max_rel(got, want) -> float:
    return max(rel_err(a, b)[1] for a, b in zip(got, want))


# -- phases ----------------------------------------------------------------------
def check_kernels(models, gen) -> dict:
    """Phase 2: every kernel against its plain version at every level."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.policy import cast_tree

    adj = adjoint_ops()
    errors = {k: {} for k in KERNEL_INFO}

    def record(kname, dname, absd, rel, where):
        worst = errors[kname].get(dname, (0.0, 0.0))
        errors[kname][dname] = (max(worst[0], absd), max(worst[1], rel))
        if not rel <= TOL[dname]:
            raise AssertionError(f"{kname} {where} {dname}: relative error "
                                 f"{rel:.3g} > {TOL[dname]}")

    from repro_torch.kernels import pyramid

    nn = nn_ops()
    for cname, (icr, mats, _) in models.items():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            m = cast_tree(mats, dtype)
            gen.manual_seed(1)
            case = pyramid_case(icr, m, dtype, gen)
            if case is not None:
                geoms, field, levels = case
                got = pyramid.refine_pyramid_core(field, geoms, levels)
                torch.cuda.synchronize()
                ref = pyramid.refine_pyramid_plain(field, geoms, levels)
                record(PYRAMID, dname, *rel_err(got, ref),
                       f"{cname} cover {len(geoms)}")
                if icr.chart.ndim == 1:
                    # a 1-D level runs its per-level kernel's body: the
                    # same sums, so the same bits
                    kern, args, _ = per_level_chain(field, geoms, levels)[-1]
                    if not torch.equal(got, kern(*args).reshape(got.shape)):
                        raise AssertionError(
                            f"{cname} {dname}: the pyramid differs from "
                            f"its per-level kernels")
            for lvl in range(icr.chart.n_levels):
                if icr.chart.ndim > 1:
                    for name, coarse, r, t, _ in nn_cases(icr, m, lvl,
                                                          dtype, gen):
                        kern, plain = nn[name]
                        got = kern(coarse, r, t)
                        torch.cuda.synchronize()
                        record(name, dname,
                               *rel_err(got, plain(coarse, r, t)),
                               f"{cname} level {lvl} rows {coarse.shape[0]}")
                geom, field, xi, r, d, axis_mats = level_inputs(
                    icr, m, lvl, dtype, gen)
                route, args = dispatch.level_operands(
                    field, xi, r, d, geom, axis_mats=axis_mats,
                    sample_axis=True)
                got = dispatch.KERNELS[route](*args)
                torch.cuda.synchronize()
                ref = dispatch.PLAIN[route](*args)
                record(dispatch.KERNEL_OF_ROUTE[route], dname,
                       *rel_err(got, ref), f"{cname} level {lvl}")
                for name, g, r1, d1, length in adjoint_cases(
                        icr, m, lvl, dtype, gen):
                    kern, plain = adj[name]
                    got = as_tuple(kern(g, r1, d1, coarse_len=length))
                    torch.cuda.synchronize()
                    want = as_tuple(plain(g, r1, d1, coarse_len=length))
                    absd = max(rel_err(a, b)[0] for a, b in zip(got, want))
                    record(name, dname, absd, max_rel(got, want),
                           f"{cname} level {lvl} g {tuple(g.shape)}")
    from repro_torch.kernels import icr_refine

    for dtype in (torch.float32, torch.bfloat16):
        gen.manual_seed(2)
        args = nd_axes_operands(models, dtype, gen)
        got = icr_refine.refine_charted(*args)
        torch.cuda.synchronize()
        record("refine_charted", str(dtype).split(".")[1],
               *rel_err(got, icr_refine.refine_charted_plain(*args)),
               f"dust nd-axes axis 0 rows {args[0].shape[0]}")
    missing = [k for k, v in errors.items() if not v]
    if missing:
        raise AssertionError(f"kernels never checked: {missing}")
    return errors


def eig_cases(problems) -> dict:
    """The batches the eigensolver takes on the main path: per learned-θ
    path the largest its build hands ``sym_eig`` (by matrices, then n), and
    the 65,536 4x4 D's of log's last level (the largest batch of any
    build), each (batch, n, n), recorded from ``ICR.matrices``."""
    from repro_torch.kernels import sym_eig

    out = {}
    for name in ("regular", "dust_theta", "log_polar_theta", "log"):
        icr = problems[name]["icr"]
        seen, real = [], sym_eig.sym_eig

        def spy(mat, *args, seen=seen, real=real, **kw):
            seen.append(mat.detach().reshape((-1,) + mat.shape[-2:]).clone())
            return real(mat, *args, **kw)

        sym_eig.sym_eig = spy
        try:
            icr.matrices()
        finally:
            sym_eig.sym_eig = real
        if name == "log":
            seen = [m for m in seen if m.shape[-1] == icr.chart.n_fsz]
        a = max(seen, key=lambda m: (m.shape[0], m.shape[-1]))
        out[f"{name}-{a.shape[0]}x{a.shape[1]}x{a.shape[2]}"] = a
    return out


def check_sym_eig(cases) -> dict:
    """Phase 2, the eigensolver: the kernel against its plain version on
    the card at every case of ``eig_cases`` (eigenvalues and eigenvectors
    bit for bit; the largest difference relative to the largest
    eigenvalue, held at 1e-6) and its status under ``BOUND``."""
    import torch

    from repro_torch.kernels import sym_eig

    out = {}
    for name, a in cases.items():
        got, want = sym_eig.sym_eig(a), sym_eig.sym_eig_plain(a)
        torch.cuda.synchronize()
        absd = max(float((g - w).abs().max()) for g, w in zip(got[:2],
                                                              want[:2]))
        rel = absd / max(float(want[0].abs().max()), 1e-30)
        out[name] = {"equal": all(torch.equal(g, w) for g, w
                                  in zip(got[:2], want[:2])),
                     "max_abs_err": absd, "max_rel_err": rel,
                     "status_max": float(got[2].max())}
        if not (rel <= 1e-6 and out[name]["status_max"] <= sym_eig.BOUND):
            raise AssertionError(f"sym_eig {name}: {out[name]}")
    return out


def sym_eig_times(cases, bandwidth, flush) -> dict:
    """Per case of ``eig_cases``: the kernel's, its plain version's and
    ``torch.linalg.eigh``'s milliseconds on the same batch (null where the
    library refuses the batch, with its error), and the bound: the batch
    read once and its eigenpairs and status written once at the card's
    bandwidth, against the rotations' float32 operations (``sweeps ·
    (m−1) · m/2`` rotations of 18n + 15 flops each) at its peak."""
    import torch

    from repro_torch.kernels import sym_eig

    out = {}
    for name, a in cases.items():
        b, n = a.shape[0], a.shape[-1]
        m = n + n % 2
        flops = sym_eig.sweeps_for(n) * (m - 1) * (m // 2) * (18 * n + 15)
        bound_ms, bound_by = bound((2 * n * n + n + 1) * 4 * b,
                                   b * flops / 2, bandwidth)
        entry = {"batch": b, "n": n,
                 "ms": time_ms(lambda a=a: sym_eig.sym_eig(a), flush),
                 "plain_ms": time_ms(lambda a=a: sym_eig.sym_eig_plain(a),
                                     flush),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None}
        try:
            entry["library_ms"] = time_ms(lambda a=a: torch.linalg.eigh(a),
                                          flush)
        except RuntimeError as exc:   # cuSOLVER refuses some batches
            entry["library_error"] = str(exc)[:200]
        out[name] = entry
    return out


def check_path(models, gen) -> tuple:
    """Phase 3: sample_batch at both policies, twice per chart: with the
    pyramid (the default), which must launch once for its cover and the
    per-level kernel once for every other level, and with
    ``use_pyramid=False``, every level on its per-level kernel."""
    import torch

    from repro_torch import ICR
    from repro_torch.kernels import build, dispatch

    launches = {k: 0 for k in KERNEL_INFO}
    path_err, covers = {}, {}
    for cname, (icr0, _, _) in models.items():
        for pol in (None, "bf16"):
            for use_pyramid in (True, False):
                icr = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                          dtype_policy=pol, use_pyramid=use_pyramid)
                build.LAUNCHES.clear()
                gen.manual_seed(7)
                out = icr.sample_batch(gen, S)
                torch.cuda.synchronize()
                counts = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
                for k, n in counts.items():
                    launches[k] += n
                key = f"{cname}-{pol or 'fp32'}" + (
                    "" if use_pyramid else "-per-level")
                cover = (dispatch.pyramid_cover(
                    icr.chart, samples=S,
                    itemsize=icr.policy.storage_dtype.itemsize)
                    if use_pyramid else None) or 0
                if use_pyramid:
                    covers[key] = cover
                want = dispatch.plan(icr.chart)[0]["kernel"]
                expect = {want: icr.chart.n_levels - cover,
                          PYRAMID: int(cover > 0)}
                if {k: counts[k] for k in expect} != expect or sum(
                        counts.values()) != sum(expect.values()):
                    raise AssertionError(f"{key}: launches {counts}, "
                                         f"expected {expect}")
                gen.manual_seed(7)
                xi = icr.init_xi(gen, batch=S)
                ref = plain_apply(icr, icr.matrices(), xi)
                if (tuple(out.shape) != (S,) + icr.chart.final_shape
                        or not bool(torch.isfinite(out).all())):
                    raise AssertionError(f"{key}: bad output "
                                         f"{tuple(out.shape)}")
                _, rel = rel_err(out, ref)
                tol = TOL["float32" if pol is None else "bfloat16"]
                path_err[key] = rel
                if not rel <= tol:
                    raise AssertionError(f"{key}: whole path relative "
                                         f"error {rel:.3g} > {tol}")
    missing = [k for k in FORWARD + (PYRAMID,) if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    return launches, path_err, covers


# learned-θ paths: chart -> (ρ of the data, mean and std of ρ's lognormal
# prior); regular's are multiples of its point count
THETA_PATHS = {"regular": (0.04, 0.06, 0.03), "dust_theta": (0.5, 0.8, 0.4),
               "log_polar_theta": (2.0, 3.0, 1.5)}


# dρ through the kernels against the float64 witness: set where the
# level-0 root was a float32 eigh, whose rounding near the clip its
# derivative 1/(2 sqrt λ) amplified (0.38 % on a (6, 8, 8) dust chart on
# the CPU); the float64 Cholesky root leaves ~1e-5 (PERF.md)
DRHO_F64_TOL = 1e-2


def train_problems(models, gen) -> dict:
    """Per path: the float32 ICR of the training path, its data
    (``charted_gp_dataset``), its likelihood, initial parameters, and its
    forward map through the kernels (``forward``) and, at fixed θ, through
    the plain versions (``plain_forward``). ``regular``, ``dust_theta`` and
    ``log_polar_theta`` learn (ξ, ρ) jointly under a lognormal prior on ρ,
    as ``examples/gp_regression_vi.py`` does: their forward rebuilds the
    matrices from θ (``ICR.__call__``); the N-D ones train through the
    pyramid's replay over the nd-axes route."""
    from repro_torch import (ICR, StandardizedModel, charted_gp_dataset,
                             gaussian_log_likelihood, lognormal_prior)

    out = {}
    paths = [(c, c) for c in models] + [("dust_theta", "dust"),
                                        ("log_polar_theta", "log_polar")]
    for pname, cname in paths:
        icr, mats, _ = models[cname]
        p = {}
        if pname in THETA_PATHS:
            scale = icr.chart.size if pname == "regular" else 1
            rho, mean, std = (scale * v for v in THETA_PATHS[pname])
            icr = ICR(icr.chart, icr.kernel.with_defaults(rho=rho),
                      use_pallas=True)
            priors = StandardizedModel({"rho": lognormal_prior(mean, std)})

            def joint(latent, icr=icr, priors=priors):
                theta = dict(priors(latent[1]))
                theta["sigma"] = 1.0
                return icr(latent[0], theta)

            # the example's lr (2e-2 at n0 = 64 level-0 points) at the
            # same step of the dominant level-0 mode: every one of the n0
            # coordinates of ξ0 reaches it through the symmetric root
            # V sqrt(Λ) Vᵀ, so Adam's per-coordinate step moves it by
            # lr·sqrt(n0)
            n0 = math.prod(icr.chart.shape(0))
            p.update(priors=priors, params=(icr.zero_xi(), priors.zero_xi()),
                     forward=joint, lr=2e-2 * math.sqrt(64 / n0))
        else:
            p.update(params=icr.zero_xi(), lr=3e-2,
                     forward=lambda xi, icr=icr, m=mats: icr.apply_sqrt(m, xi),
                     plain_forward=lambda xi, icr=icr, m=mats: plain_apply(
                         icr, m, [x[None] for x in xi])[0])
        gen.manual_seed(21)
        _, obs_idx, y = charted_gp_dataset(icr, gen, obs_frac=OBS_FRAC,
                                           noise_std=NOISE)
        p.update(icr=icr, mats=mats, y=y, obs_idx=obs_idx,
                 ll=gaussian_log_likelihood(NOISE, obs_idx))
        out[pname] = p
    return out


def theta_gradient(pname, p, point) -> dict:
    """A learned-θ path's joint (ξ, ρ) gradient at ξ = `point`, ρ's latent
    0.3: the matrices are built once from θ and the loss differentiated
    through the kernels and through the plain versions on the card. The
    ξ gradients are held at 1e-5 and the matrix cotangents (d sqrt0 and
    every level's dR, dsqrtD, or on N-D charts every per-axis factor's)
    at 1e-4: they are everything the kernel route contributes to dρ. dρ
    sums them through the square roots' backward, which weighs modes near
    the clip by up to 1/(2 sqrt(eps)), so dρ through the kernels is held
    against the plain versions' at 1e-3. The witness of dρ itself is the plain versions in float64 on the
    card, matrices built in float64 (``ICR.matrices(dtype=)``): dρ through
    the kernels is held against it at ``DRHO_F64_TOL`` (PERF.md). The
    plain versions in float32 on the CPU are reported beside them."""
    import torch

    from repro_torch import ICR, gaussian_log_likelihood, neg_log_joint
    from repro_torch.kernels.policy import tree_leaves

    def grads(icr, applies, obs_idx, y, point, dtype=torch.float32):
        rho = torch.tensor(0.3, device=icr.device, dtype=dtype,
                           requires_grad=True)
        theta = dict(p["priors"]({"rho": rho}))
        theta["sigma"] = 1.0
        mats = icr.matrices(theta, dtype=dtype)
        leaves = tree_leaves(mats)
        ll = gaussian_log_likelihood(NOISE, obs_idx)
        out = []
        for apply in applies:
            xi = _trainable([x.to(dtype) for x in point])
            loss = neg_log_joint(ll, lambda x: apply(mats, x))(
                xi, y.to(dtype))
            g = torch.autograd.grad(loss, xi + leaves + [rho],
                                    retain_graph=True)
            out.append((g[:len(xi)], g[len(xi):-1], float(g[-1])))
        return out

    icr = p["icr"]
    plain = [lambda m, xi, icr=icr: plain_apply(icr, m, [x[None]
                                                          for x in xi])[0]]
    (gx, gm, drho), (px, pm, prho) = grads(
        icr, [icr.apply_sqrt] + plain, p["obs_idx"], p["y"], point)
    ((_, _, wrho),) = grads(icr, plain, p["obs_idx"], p["y"], point,
                            dtype=torch.float64)
    cpu = ICR(icr.chart, icr.kernel, use_pallas=True, device="cpu")
    plain_cpu = [lambda m, xi: plain_apply(cpu, m, [x[None]
                                                     for x in xi])[0]]
    ((_, _, crho),) = grads(cpu, plain_cpu, p["obs_idx"].cpu(),
                            p["y"].cpu(), [x.cpu() for x in point])
    mat_err = max_rel(gm, pm)
    out = {"grad_xi_max_rel_err": max_rel(gx, px),
           "grad_mats_max_rel_err": mat_err,
           "drho": {"kernels": drho, "plain": prho, "plain_f64": wrho,
                    "plain_cpu": crho},
           "drho_rel_err": abs(drho - prho) / abs(prho),
           "drho_vs_f64_rel_err": abs(drho - wrho) / abs(wrho),
           "drho_plain_vs_f64_rel_err": abs(prho - wrho) / abs(wrho),
           "drho_plain_cpu_vs_f64_rel_err": abs(crho - wrho) / abs(wrho),
           "drho_plain_card_vs_cpu_rel": abs(prho - crho) / abs(crho)}
    print(f"{pname} θ-gradient: {json.dumps(out)}", file=sys.stderr)
    if not mat_err <= 1e-4:
        raise AssertionError(f"{pname}: matrix cotangent relative error "
                             f"{mat_err:.3g} > 1e-4")
    if not out["drho_rel_err"] <= 1e-3:
        raise AssertionError(f"{pname}: dρ through the kernels is "
                             f"{out['drho_rel_err']:.3g} > 1e-3 from the "
                             f"plain versions'")
    if not out["drho_vs_f64_rel_err"] <= DRHO_F64_TOL:
        raise AssertionError(f"{pname}: dρ through the kernels is "
                             f"{out['drho_vs_f64_rel_err']:.3g} > "
                             f"{DRHO_F64_TOL} from the float64 witness")
    return out


def _trainable(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().requires_grad_(True)
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return type(tree)(_trainable(v) for v in tree)


def check_train(problems, gen) -> tuple:
    """Phase 4: the training paths on the kernels, one step's gradient
    against the plain versions', and apply_sqrt_T against autograd (on
    the fixed-θ twin of each chart)."""
    import torch

    from repro_torch import ICR, advi_fit, map_fit, neg_log_joint
    from repro_torch.kernels import build

    launches = {k: 0 for k in COUNTED}
    report = {}
    for cname, p in problems.items():
        icr = p["icr"]
        build.LAUNCHES.clear()
        # every fit is compiled: a learned-θ step captures its matrix build
        fit, losses = map_fit(p["ll"], p["forward"], p["params"], p["y"],
                              steps=20 if cname == "dust" else 10,
                              lr=p["lr"])
        entry = {"map_losses": [float(v) for v in losses]}
        if cname == "dust":
            _, elbos = advi_fit(
                gen, p["ll"],
                lambda xi, icr=icr, m=p["mats"]: icr.apply_sqrt_batch(m, xi),
                icr.zero_xi(), p["y"], steps=10, n_mc=2)
            entry["advi_elbos"] = [float(v) for v in elbos]
            if not (bool(torch.isfinite(elbos).all())
                    and float(elbos[-1]) > float(elbos[0])):
                raise AssertionError(f"dust ADVI: the ELBO did not rise: "
                                     f"{entry['advi_elbos']}")
        torch.cuda.synchronize()
        counts = {k: build.LAUNCHES[k] for k in COUNTED}
        entry["launches"] = counts
        if not (bool(torch.isfinite(losses).all())
                and float(losses[-1]) < float(losses[0])):
            raise AssertionError(f"{cname}: the MAP loss did not fall: "
                                 f"{entry['map_losses']}")
        if cname in THETA_PATHS:
            entry["rho_hat"] = float(p["priors"](fit[1])["rho"])
            if not torch.isfinite(torch.tensor(entry["rho_hat"])):
                raise AssertionError(f"{cname}: rho_hat {entry['rho_hat']}")
        silent = [k for k in TRAIN_REACHES[cname] if counts[k] == 0]
        if silent:
            raise AssertionError(f"{cname}: kernels never launched on the "
                                 f"training path: {silent}")
        for k in COUNTED:
            launches[k] += counts[k]

        # one step's gradient, through the kernels and the plain versions
        gen.manual_seed(23)
        point = [0.5 * x for x in icr.init_xi(gen)]
        if cname in THETA_PATHS:
            entry.update(theta_gradient(cname, p, point))
        else:
            grads = []
            for f in (p["forward"], p["plain_forward"]):
                params = _trainable(point)
                loss = neg_log_joint(p["ll"], f)(params, p["y"])
                grads.append(torch.autograd.grad(loss, params))
            entry["grad_xi_max_rel_err"] = max_rel(*grads)
        if not entry["grad_xi_max_rel_err"] <= TOL["float32"]:
            raise AssertionError(
                f"{cname}: ξ gradient relative error "
                f"{entry['grad_xi_max_rel_err']:.3g} > {TOL['float32']}")

        # the transpose on the kernels against autograd of the plain apply
        report[cname] = entry
        if cname.endswith("_theta"):
            continue
        entry["apply_sqrt_T_max_rel_err"] = {}
        for pol in (None, "bf16"):
            icr_p = ICR(icr.chart, icr.kernel, use_pallas=True,
                        dtype_policy=pol)
            m = icr_p.matrices()
            dt = icr_p.policy.storage_dtype
            gen.manual_seed(29)
            v = torch.randn((2,) + icr_p.out_shape, generator=gen,
                            device="cuda").to(dt)
            got = icr_p.apply_sqrt_T_batch(m, v)
            zero = [torch.zeros((2,) + s, dtype=dt, device="cuda",
                                requires_grad=True)
                    for s in icr_p.xi_shapes()]
            want = torch.autograd.grad(plain_apply(icr_p, m, zero), zero, v)
            err = max_rel(got, want)
            tol = TOL["float32" if pol is None else "bfloat16"]
            entry["apply_sqrt_T_max_rel_err"][pol or "fp32"] = err
            if not err <= tol:
                raise AssertionError(f"{cname} {pol}: apply_sqrt_T relative "
                                     f"error {err:.3g} > {tol}")
    return launches, report


GRAPH_FITS = ("dust", "log", "log_polar")   # the fixed-θ training paths
GRAPH_STEPS = 10


def same_bits(a, b) -> bool:
    """Every tensor of `a` equal to its counterpart in `b`, bit for bit."""
    import torch

    from repro_torch.kernels.policy import tree_leaves

    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def check_graphs(problems, models, gen) -> tuple:
    """Phase 4b: the compiled paths as CUDA graphs, each held bit for bit
    against the same code run op by op on the card: ``map_fit(jit=True)``
    against ``jit=False`` on dust, log and log_polar (losses and ξ̂, 10
    steps), the dust ADVI fit against its eager twin from the same
    generator state, ``apply_sqrt_T_batch`` (a replay of its cached graph)
    against its op-by-op chain on the four charts at S = 1 and 8 and both
    dtype policies (and against autograd of the plain apply at 1e-5 /
    5e-2), and the learned-θ fits: ``map_fit(jit=True)`` against
    ``jit=False`` on regular, dust_theta and log_polar_theta (losses, ξ̂
    and ρ's latent; the matrices rebuilt inside the captured step) and a
    learned-θ ``advi_fit`` on regular (one build per draw, ``per_draw``)
    against its eager twin. Every capture checks that its kernel nodes
    equal its wrappers' launches and their launch plans; every graphed
    path must launch the kernels its chart reaches, the counters zeroed
    just before and read just after. Returns ``(launches, record)``."""
    import torch

    from repro_torch import ICR, advi_fit, map_fit, per_draw
    from repro_torch.core import graphs
    from repro_torch.kernels import build

    launches = {k: 0 for k in COUNTED}

    def read(what, reaches):
        torch.cuda.synchronize()
        counts = {k: build.LAUNCHES[k] for k in COUNTED}
        silent = [k for k in reaches if counts[k] == 0]
        if silent:
            raise AssertionError(f"graphs {what}: kernels never launched: "
                                 f"{silent}")
        for k, n in counts.items():
            launches[k] += n
        return counts

    record = {"fits": {}, "apply_sqrt_T": {}}
    for cname in GRAPH_FITS:
        p = problems[cname]
        args = (p["ll"], p["forward"], p["params"], p["y"])
        build.LAUNCHES.clear()
        fit_g, loss_g = map_fit(*args, steps=GRAPH_STEPS, lr=p["lr"])
        counts = read(f"{cname} map_fit", TRAIN_REACHES[cname])
        fit_e, loss_e = map_fit(*args, steps=GRAPH_STEPS, lr=p["lr"],
                                jit=False)
        entry = {"losses_equal": same_bits(loss_g, loss_e),
                 "xi_equal": same_bits(fit_g, fit_e),
                 "launches": counts}
        if cname == "dust":
            icr, m = p["icr"], p["mats"]

            def fwd(xi, icr=icr, m=m):
                return icr.apply_sqrt_batch(m, xi)

            gen.manual_seed(41)
            build.LAUNCHES.clear()
            q_g, elbo_g = advi_fit(gen, p["ll"], fwd, icr.zero_xi(), p["y"],
                                   steps=GRAPH_STEPS)
            read("dust advi_fit", TRAIN_REACHES[cname])
            gen.manual_seed(41)
            with graphs.eager():
                q_e, elbo_e = advi_fit(gen, p["ll"], fwd, icr.zero_xi(),
                                       p["y"], steps=GRAPH_STEPS)
            entry.update(advi_elbos_equal=same_bits(elbo_g, elbo_e),
                         advi_params_equal=same_bits(q_g, q_e))
        record["fits"][cname] = entry
        if not all(v for k, v in entry.items() if k != "launches"):
            raise AssertionError(f"graphs {cname}: the graphed fit differs "
                                 f"from the eager one: {entry}")

    for cname, (icr0, _, _) in models.items():
        for pol in (None, "bf16"):
            icr = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                      dtype_policy=pol)
            m = icr.matrices()
            dt = icr.policy.storage_dtype
            tol = TOL["float32" if pol is None else "bfloat16"]
            for n_s in (1, S):
                gen.manual_seed(43)
                v = torch.randn((n_s,) + icr.out_shape, generator=gen,
                                device="cuda").to(dt)
                build.LAUNCHES.clear()
                first = icr.apply_sqrt_T_batch(m, v)    # captures
                again = icr.apply_sqrt_T_batch(m, v)    # replays
                read(f"{cname} apply_sqrt_T", ())
                want = icr.apply_sqrt_T_batch(m, v, cached=False)
                zero = [torch.zeros((n_s,) + s, dtype=dt, device="cuda",
                                    requires_grad=True)
                        for s in icr.xi_shapes()]
                plain = torch.autograd.grad(plain_apply(icr, m, zero), zero,
                                            v)
                entry = {"equal": same_bits(first, want)
                         and same_bits(again, want),
                         "graphs": len(icr._sqrt_T_graphs),
                         "plain_max_rel_err": max_rel(first, plain)}
                record["apply_sqrt_T"][f"{cname}-{pol or 'fp32'}-S{n_s}"] = \
                    entry
                if not (entry["equal"]
                        and entry["plain_max_rel_err"] <= tol):
                    raise AssertionError(f"graphs {cname} {pol} S={n_s}: "
                                         f"apply_sqrt_T {entry}")
            del icr, m

    # learned θ: the step rebuilds the matrices from θ inside the graph
    record["learned_theta"] = {}
    for cname in THETA_PATHS:
        p = problems[cname]
        args = (p["ll"], p["forward"], p["params"], p["y"])
        build.LAUNCHES.clear()
        fit_g, loss_g = map_fit(*args, steps=GRAPH_STEPS, lr=p["lr"])
        counts = read(f"{cname} learned-θ map_fit", TRAIN_REACHES[cname])
        nodes = graphs.CAPTURES[-1]
        fit_e, loss_e = map_fit(*args, steps=GRAPH_STEPS, lr=p["lr"],
                                jit=False)
        entry = {"losses_equal": same_bits(loss_g, loss_e),
                 "xi_equal": same_bits(fit_g[0], fit_e[0]),
                 "rho_latent_equal": same_bits(fit_g[1], fit_e[1]),
                 "kernel_nodes": len(nodes["nodes"]),
                 "nodes_equal_plans": sorted(nodes["nodes"])
                 == sorted(nodes["planned"]),
                 "launches": counts}
        if cname == "regular":
            gen.manual_seed(47)
            build.LAUNCHES.clear()
            q_g, elbo_g = advi_fit(gen, p["ll"], per_draw(p["forward"]),
                                   p["params"], p["y"], steps=GRAPH_STEPS,
                                   lr=p["lr"])
            read("regular learned-θ advi_fit", TRAIN_REACHES[cname])
            gen.manual_seed(47)
            with graphs.eager():
                q_e, elbo_e = advi_fit(gen, p["ll"], per_draw(p["forward"]),
                                       p["params"], p["y"],
                                       steps=GRAPH_STEPS, lr=p["lr"])
            entry.update(advi_elbos_equal=same_bits(elbo_g, elbo_e),
                         advi_params_equal=same_bits(q_g, q_e))
        record["learned_theta"][cname] = entry
        if not all(v for k, v in entry.items()
                   if k not in ("launches", "kernel_nodes")):
            raise AssertionError(f"graphs {cname}: the graphed learned-θ "
                                 f"fit differs from the eager one: {entry}")
    torch.cuda.synchronize()
    record["launches"] = launches
    return launches, record


def per_level_chain(field, geoms, levels) -> list:
    """The per-level kernels the pyramid replaces, on its operands: per
    level ``(kernel wrapper, its operands, route)``, each level's coarse
    input the previous level's kernel output, reflect-padded."""
    from repro_torch.core.refine import reflect_pad
    from repro_torch.kernels import dispatch

    chain, x = [], field
    n_s = field.shape[0]
    for geom, (xi0, rs, d0) in zip(geoms, levels):
        nd = len(geom.coarse_shape)
        if geom.boundary == "reflect":
            x = reflect_pad(x, geom.b, nd)
        if nd == 1:
            route = (dispatch.ROUTE_CHARTED_1D if rs[0].ndim == 3
                     else dispatch.ROUTE_STATIONARY_1D)
            args = (x.contiguous(), xi0.reshape(n_s, geom.T[0], geom.n_fsz),
                    rs[0], d0)
        else:
            route = dispatch.ROUTE_ND_FUSED
            args = (x.contiguous(), xi0, rs[0], d0, tuple(rs[1:]),
                    tuple(geom.T))
        kern = dispatch.KERNELS[route]
        x = kern(*args).reshape((n_s,) + tuple(geom.fine_shape))
        chain.append((kern, args, route))
    return chain


def kernel_times(models, bandwidth, flush, gen) -> dict:
    """Per kernel at the largest level of its chart (the noise-free passes
    at their axis; the pyramid at regular's cover, the one ``ICR`` runs),
    float32 and bfloat16 storage: kernel, plain version and library call
    times, and the bound. The pyramid has no library call; beside it stand
    the per-level kernels it replaces, timed one by one on the same
    operands, and (``dust_prefix``) its time at the dust prefix."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.policy import cast_tree

    adj = adjoint_ops()
    out = {}
    for kname, info in KERNEL_INFO.items():
        icr, mats, _ = models[info["chart"]]
        lvl = icr.chart.n_levels - 1
        per_dtype = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            m = cast_tree(mats, dtype)
            gen.manual_seed(3)
            library_ms = library_call = None
            if kname in FORWARD:
                geom, field, xi, r, d, axis_mats = level_inputs(
                    icr, m, lvl, dtype, gen)
                route, args = dispatch.level_operands(
                    field, xi, r, d, geom, axis_mats=axis_mats,
                    sample_axis=True)
                kern, plain = dispatch.KERNELS[route], dispatch.PLAIN[route]
                ms = time_ms(lambda: kern(*args), flush)
                plain_ms = time_ms(lambda: plain(*args), flush)
                if route == "stationary-1d":
                    coarse, _, r1, _ = args
                    c3, w = coarse[:, None, :], r1[:, None, :]
                    library_call = ("F.conv1d(coarse, R, stride=n_fsz//2): "
                                    "the window contraction without the "
                                    "noise term")
                    library_ms = time_ms(lambda: torch.nn.functional.conv1d(
                        c3, w, stride=geom.n_fsz // 2), flush)
                elif route == "charted-1d":
                    coarse, xi1, r1, _ = args
                    library_call = (f"{WINDOW_EINSUM}: the window "
                                    "contraction without the noise term")
                    library_ms = time_ms(lambda: window_einsum(
                        coarse, r1, xi1.shape[1]), flush)
                moved = operand_bytes(route, args, kern(*args))
                fmas = kernel_fmas(route, args)
                enq = enqueue_ms(lambda: kern(*args))
                shape = {"coarse": list(field.shape),
                         "fine": [S] + list(geom.fine_shape)}
                if kname == "refine_charted":
                    shape["nd_axes"] = nd_axes_time(models, dtype, gen,
                                                    bandwidth, flush)
            elif kname in NOISE_FREE:
                (_, coarse, r, t, a), = [
                    c for c in nn_cases(icr, m, lvl, dtype, gen)
                    if c[4] == info["axis"]]
                kern, plain = nn_ops()[kname]
                ms = time_ms(lambda: kern(coarse, r, t), flush)
                plain_ms = time_ms(lambda: plain(coarse, r, t), flush)
                if kname == "refine_stationary_nn":
                    c3, w = coarse[:, None, :], r[:, None, :].contiguous()
                    library_call = ("F.conv1d(coarse, R, stride=n_fsz//2): "
                                    "the same function in channel-major "
                                    "layout")
                    library_ms = time_ms(lambda: torch.nn.functional.conv1d(
                        c3, w, stride=r.shape[-2] // 2), flush)
                else:
                    library_call = (f"{WINDOW_EINSUM}: the same function "
                                    "over a view")
                    library_ms = time_ms(
                        lambda: window_einsum(coarse, r, t), flush)
                fine = kern(coarse, r, t)
                moved = sum(x.numel() * x.element_size()
                            for x in (coarse, r, fine))
                fmas = fine.numel() * r.shape[-1]
                enq = enqueue_ms(lambda: kern(coarse, r, t))
                shape = {"coarse": list(coarse.shape),
                         "fine": list(fine.shape), "level": lvl, "axis": a}
            elif kname == PYRAMID:
                cover = dispatch.pyramid_cover(icr.chart, samples=S,
                                               itemsize=dtype.itemsize)
                ms, plain_ms, moved, fmas, enq, shape = pyramid_time(
                    icr, m, dtype, gen, flush)
                if shape["levels"] != cover:
                    raise AssertionError(
                        f"{kname} timed at {shape['levels']} levels, "
                        f"ICR covers {cover}")
                shape["dust_prefix"] = pyramid_prefix_time(
                    models, dtype, gen, bandwidth, flush)
            else:
                cases = [c for c in adjoint_cases(icr, m, lvl, dtype, gen)
                         if c[0] == kname]
                _, g, r, d, length = max(cases, key=lambda c: c[1].numel())
                kern, plain = adj[kname]
                ms = time_ms(lambda: kern(g, r, d, coarse_len=length), flush)
                plain_ms = time_ms(lambda: plain(g, r, d, coarse_len=length),
                                   flush)
                if kname.startswith("refine_stationary"):
                    n_fsz = r.shape[-2]
                    gc = g.reshape(g.shape[0], -1, n_fsz).transpose(1, 2)
                    gc, w = gc.contiguous(), r[:, None, :].contiguous()
                    library_call = (
                        "F.conv_transpose1d(g, R, stride=n_fsz//2) on g in "
                        "channel-major layout: the overlap-add without dxi")
                    library_ms = time_ms(
                        lambda: torch.nn.functional.conv_transpose1d(
                            gc, w, stride=n_fsz // 2), flush)
                outs = as_tuple(kern(g, r, d, coarse_len=length))
                moved, fmas = adjoint_cost(g, r, d, outs)
                enq = enqueue_ms(lambda: kern(g, r, d, coarse_len=length))
                shape = {"g": list(g.shape), "coarse_len": length}
                if kname == "refine_charted_adjoint":
                    shape["nd_backward"] = nd_backward_time(
                        models, dtype, gen, bandwidth, flush)
            bound_ms, bound_by = bound(moved, fmas, bandwidth)
            per_dtype[dname] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "copy_ms": copy_ms(moved, flush),
                "enqueue_ms": enq, "library_call": library_call,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                "level": lvl, "shape": shape}
        out[kname] = per_dtype
    return out


def nd_axes_operands(models, dtype, gen) -> tuple:
    """The other shape of #3's launches: the axis-0 pass (with ξ0) of the
    nd-axes route at dust's last level, as a learned-θ training step (S=1)
    launches it, very many short rows: ``(coarse, xi, r, d)``."""
    import torch

    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels.policy import cast_tree

    icr, mats, _ = models["dust"]
    lvl = icr.chart.n_levels - 1
    geom = LevelGeom.for_level(icr.chart, lvl)
    fsz, t = geom.n_fsz, geom.T
    b = geom.b if geom.boundary == "reflect" else 0
    rows = math.prod(n * fsz for n in t[1:])
    r = cast_tree(mats["Rax"][lvl][0], dtype).contiguous()
    d = cast_tree(mats["sqrtDax"][lvl][0], dtype).contiguous()
    coarse = torch.randn((rows, geom.coarse_shape[0] + 2 * b), generator=gen,
                         device="cuda").to(dtype)
    xi = torch.randn((rows, t[0], fsz), generator=gen,
                     device="cuda").to(dtype)
    return coarse, xi, r, d


def nd_axes_time(models, dtype, gen, bandwidth, flush) -> dict:
    """#3 at the nd-axes route's axis-0 shape (``nd_axes_operands``)."""
    from repro_torch.kernels import icr_refine as ir

    args = nd_axes_operands(models, dtype, gen)
    ms = time_ms(lambda: ir.refine_charted(*args), flush)
    moved = operand_bytes("charted-1d", args, ir.refine_charted(*args))
    bound_ms, bound_by = bound(moved, kernel_fmas("charted-1d", args),
                               bandwidth)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved, "copy_ms": copy_ms(moved, flush),
            "coarse": list(args[0].shape), "xi": list(args[1].shape),
            "chart": "dust", "level": models["dust"][0].chart.n_levels - 1,
            "axis": 0, "samples": 1}


def nd_backward_time(models, dtype, gen, bandwidth, flush) -> dict:
    """#7 at the other shape of its launches: the axis-0 pass (with dxi)
    of the N-D backward at dust's last level, very many short rows."""
    import torch

    from repro_torch.kernels import icr_refine as ir
    from repro_torch.kernels.policy import cast_tree

    icr, mats, _ = models["dust"]
    lvl = icr.chart.n_levels - 1
    m = cast_tree(mats, dtype)
    (_, g, r, d, length), = [
        c for c in adjoint_cases(icr, m, lvl, dtype, gen)
        if c[0] == "refine_charted_adjoint"]
    ms = time_ms(lambda: ir.refine_charted_adjoint(g, r, d,
                                                   coarse_len=length), flush)
    outs = ir.refine_charted_adjoint(g, r, d, coarse_len=length)
    moved, fmas = adjoint_cost(g, r, d, outs)
    bound_ms, bound_by = bound(moved, fmas, bandwidth)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved, "copy_ms": copy_ms(moved, flush),
            "g": list(g.shape), "coarse_len": length, "chart": "dust",
            "level": lvl, "axis": 0}


def pyramid_time(icr, mats, dtype, gen, flush) -> tuple:
    """#10 at `icr`'s residency prefix (S=8): ``(ms, plain_ms, bytes,
    fmas, enqueue_ms, shape)``, the shape holding the per-level kernels it
    replaces, each timed alone on the same operands (its yardstick)."""
    from repro_torch.kernels import pyramid

    geoms, field, levels = pyramid_case(icr, mats, dtype, gen)
    ms = time_ms(lambda: pyramid.refine_pyramid_core(field, geoms, levels),
                 flush)
    grid = pyramid.last_grid
    plain_ms = time_ms(lambda: pyramid.refine_pyramid_plain(
        field, geoms, levels), flush)
    chain = per_level_chain(field, geoms, levels)
    chain_ms = [time_ms(lambda k=k, a=a: k(*a), flush) for k, a, _ in chain]
    fine = pyramid.refine_pyramid_core(field, geoms, levels)
    moved = sum(x.numel() * x.element_size() for x in (
        field, fine, *(t for xi0, rs, d0 in levels for t in (xi0, *rs, d0))))
    fmas = sum(kernel_fmas(route, a) for _, a, route in chain)
    enq = enqueue_ms(lambda: pyramid.refine_pyramid_core(field, geoms,
                                                         levels))
    shape = {"coarse": list(field.shape), "fine": list(fine.shape),
             "levels": len(geoms), "grid_blocks": grid,
             "per_level_kernels_ms": chain_ms,
             "per_level_kernels_sum_ms": sum(chain_ms)}
    return ms, plain_ms, moved, fmas, enq, shape


def pyramid_prefix_time(models, dtype, gen, bandwidth, flush) -> dict:
    """#10 at the dust prefix, which ``pyramid_cover`` declines (ICR runs
    the per-level kernels there), with its bound and copy time."""
    from repro_torch.kernels.policy import cast_tree

    icr, mats, _ = models["dust"]
    ms, _, moved, fmas, _, shape = pyramid_time(
        icr, cast_tree(mats, dtype), dtype, gen, flush)
    bound_ms, bound_by = bound(moved, fmas, bandwidth)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": moved, "copy_ms": copy_ms(moved, flush),
            "chart": "dust", **shape}


def copy_ms(moved, flush) -> float:
    """A device copy of `moved` bytes (half read, half written)."""
    import torch

    src = torch.empty(moved // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src), flush)


def pyramid_covers(models, flush, gen) -> dict:
    """Per chart and storage dtype, the pyramid at its residency prefix
    (S=8) against the per-level kernels it replaces, each timed alone on
    the same operands: the pyramid's yardstick, since no PyTorch call
    computes it. ``kept``: whether ``dispatch.pyramid_cover`` takes the
    prefix (``ICR`` runs the pyramid there); ``faster``: whether the
    pyramid beat the per-level kernels summed in this run."""
    import torch

    from repro_torch.kernels import dispatch, pyramid
    from repro_torch.kernels.policy import cast_tree

    out = {}
    for cname, (icr, mats, _) in models.items():
        for dtype in (torch.float32, torch.bfloat16):
            gen.manual_seed(13)
            geoms, field, levels = pyramid_case(
                icr, cast_tree(mats, dtype), dtype, gen)
            ms = time_ms(lambda: pyramid.refine_pyramid_core(
                field, geoms, levels), flush)
            chain = [time_ms(lambda k=k, a=a: k(*a), flush)
                     for k, a, _ in per_level_chain(field, geoms, levels)]
            out[f"{cname}-{str(dtype).split('.')[1]}"] = {
                "cover": len(geoms), "levels": icr.chart.n_levels,
                "kept": dispatch.pyramid_cover(
                    icr.chart, samples=S, itemsize=dtype.itemsize)
                is not None,
                "ms": ms, "faster": ms < sum(chain),
                "grid_blocks": pyramid.last_grid,
                "per_level_kernels_ms": chain,
                "per_level_kernels_sum_ms": sum(chain)}
    return out


def level_split(models, flush, gen) -> dict:
    """Per level of each chart at float32: the torch glue before a forward
    launch against the kernel, and a level's whole transpose
    (``dispatch.refine_T``: adjoint kernels, movedim copies and the
    transposed glue) against its adjoint kernels alone."""
    import torch

    from repro_torch.kernels import dispatch

    adj = adjoint_ops()
    split = {}
    for cname, (icr, mats, _) in models.items():
        gen.manual_seed(5)
        rows = []
        for lvl in range(icr.chart.n_levels):
            geom, field, xi, r, d, axis_mats = level_inputs(
                icr, mats, lvl, torch.float32, gen)

            def glue():
                return dispatch.level_operands(
                    field, xi, r, d, geom, axis_mats=axis_mats,
                    sample_axis=True)

            route, args = glue()
            kern = dispatch.KERNELS[route]
            g = torch.randn((S,) + tuple(geom.fine_shape), generator=gen,
                            device="cuda")
            bwd_ms = time_ms(lambda: dispatch.refine_T(
                g, r, d, geom, axis_mats=axis_mats), flush)
            adj_ms = sum(
                time_ms(lambda c=c: adj[c[0]][0](c[1], c[2], c[3],
                                                 coarse_len=c[4]), flush)
                for c in adjoint_cases(icr, mats, lvl, torch.float32, gen))
            rows.append({"level": lvl, "glue_ms": time_ms(glue, flush),
                         "kernel_ms": time_ms(lambda: kern(*args), flush),
                         "bwd_ms": bwd_ms, "adjoint_kernel_ms": adj_ms,
                         "bwd_glue_ms": bwd_ms - adj_ms})
        split[cname] = rows
    return split


def train_step_times(problems, flush) -> dict:
    """One float32 fit step per chart (``core/vi._fit_step``: the loss,
    the backward through the kernels, AdamW in place, the loss into its
    buffer), op by op: CUDA-event milliseconds and host enqueue, and
    where they go: the loss alone (forward, recording the graph), the
    update alone, and the backward as the rest; and on the fixed-θ paths
    the same step as one replay of its captured CUDA graph (``graph_*``;
    on the learned-θ paths too, the matrix build inside the graph)."""
    import torch

    from repro_torch import neg_log_joint
    from repro_torch.core import graphs, vi
    from repro_torch.kernels.policy import tree_leaves
    from repro_torch.optim import adamw, linear_warmup_cosine

    out = {}
    for cname, p in problems.items():
        loss_fn = neg_log_joint(p["ll"], p["forward"])

        def fit_step(loss_fn=loss_fn, y=p["y"]):
            params = _trainable(p["params"])
            # far more steps than any timing runs: the loss buffer's index
            # stays in range
            step, _ = vi._fit_step(lambda q: loss_fn(q, y), params, 10_000,
                                   p["lr"])
            return params, step

        params, step = fit_step()
        leaves = tree_leaves(params)
        opt = adamw(linear_warmup_cosine(p["lr"], 2, 20))

        def loss(params=params, loss_fn=loss_fn, y=p["y"]):
            return loss_fn(params, y)

        grads = torch.autograd.grad(loss(), leaves)
        step_ms, loss_ms = time_ms(step, flush), time_ms(loss, flush)
        update_ms = time_ms(lambda: opt.update(grads, leaves), flush)
        entry = {"train_step_ms": step_ms,
                 "train_step_enqueue_ms": enqueue_ms(step),
                 "loss_ms": loss_ms, "update_ms": update_ms,
                 "backward_ms": step_ms - loss_ms - update_ms,
                 "points": p["icr"].chart.size,
                 "learns_theta": cname in THETA_PATHS}
        _, gstep = fit_step()
        replay = graphs.capture(gstep, device="cuda")
        entry.update(graph_step_ms=time_ms(replay, flush),
                     graph_step_enqueue_ms=enqueue_ms(replay),
                     graph_kernel_nodes=sum(replay.launches.values()))
        del replay
        out[cname] = entry
    return out


def draw_floor_bytes(entry, storage) -> int:
    """The least bytes a slab's draw must move, each input read once and
    each output written once: the q-parameters (mean, std: float32 over
    the excitation), the client ξ rows of the rows flagged in the entry's
    buffers, and every row's excitation written at the storage dtype. The
    hash and Box-Muller are arithmetic on counters and move nothing."""
    import torch

    n_xi, cap = sum(entry["sizes"]), entry["capacity"]
    flagged = int(entry["bufs"]["meta"][2].count_nonzero())
    width = torch.finfo(storage).bits // 8
    return 4 * n_xi * (2 + flagged) + width * n_xi * cap


def serve_case(cname, chart, rho, pol, flush, bandwidth, card) -> tuple:
    """Phase 5 on one chart and dtype policy: ``GPFieldServer(
    demo_posterior(...), slab=8)`` serves ``mixed_requests(3, 16)`` cold,
    then warm, with the launch counters zeroed just before and read just
    after; then the checks and times of the ``serve`` line. Returns
    ``(launches, record)``."""
    import numpy as np
    import torch

    from repro_torch.kernels import build, dispatch
    from repro_torch.launch import serve_gp as sg

    key = f"{cname}-{pol or 'fp32'}"
    post = sg.demo_posterior(chart, rho, dtype_policy=pol)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    srv = sg.GPFieldServer(post, slab=S)
    cold_reqs = srv.run(sg.mixed_requests(3, 16))
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    mats_stats = dict(post.icr.matrices_cache_stats)
    plan_stats = dict(dispatch.plan_cache_stats)
    rows0, slabs0 = srv.rows_served, srv.slabs_run
    t0 = time.perf_counter()
    warm_reqs = srv.run(sg.mixed_requests(3, 16))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
    m = srv.metrics()

    # 2. warm traffic: no new graph, no matrices, no plan
    if (m["graph_captures"] != m["cached_entries"] or m["graph_captures"]
            != 1 or m["mode"] != "single:cuda-graph"):
        raise AssertionError(f"serve {key}: captures {m}")
    if (dict(post.icr.matrices_cache_stats) != mats_stats
            or dict(dispatch.plan_cache_stats) != plan_stats):
        raise AssertionError(f"serve {key}: warm traffic rebuilt matrices "
                             f"or the plan")
    want = collections.Counter()
    for lvl in srv._entry["plan"]:
        want[lvl["kernel"]] += lvl["launches"]
    want = +want
    nodes = srv._entry["fn"].launches   # the graph's kernel nodes
    # each slab attempt replays the graph once; the capture's eager
    # warm-up launched every node's kernel once more
    runs = m["slabs_attempted"] + m["graph_captures"]
    if not want or nodes != want or {k: n for k, n in launches.items()
                                     if n} != {k: n * runs
                                               for k, n in nodes.items()}:
        raise AssertionError(f"serve {key}: launches {launches}, graph "
                             f"nodes {dict(nodes)}, the plan runs "
                             f"{dict(want)}")
    # 4. finite fields, positive moments std
    for r in cold_reqs + warm_reqs:
        if not r.done or r.error:
            raise AssertionError(f"serve {key}: request failed: {r.error}")
        arrays = r.fields if r.kind == "sample" else [r.mean, r.std]
        if not all(np.isfinite(a).all() for a in arrays) or (
                r.kind == "moments" and not (r.std > 0).all()):
            raise AssertionError(f"serve {key}: non-finite field or "
                                 f"non-positive std ({r.kind})")

    # 1. the graph's slab equals the eager kernel route bit for bit, and
    # the eager route its plain version (the buffers hold the last slab)
    e = srv._entry
    graph_out = e["fn"]().clone()
    xi = e["draw"](*e["args"])
    eager = post.icr.apply_sqrt_batch(e["mats"], xi).float()
    if not torch.equal(graph_out, eager):
        raise AssertionError(f"serve {key}: graph and eager slabs differ by "
                             f"{rel_err(graph_out, eager)[0]:.3g}")
    _, rel_plain = rel_err(eager, plain_apply(post.icr, e["mats"], xi))
    tol = TOL["float32" if pol is None else "bfloat16"]
    if not rel_plain <= tol:
        raise AssertionError(f"serve {key}: eager slab against the plain "
                             f"versions {rel_plain:.3g} > {tol}")
    # 3. the card's integer noise stream equals the CPU's
    if pol is None:
        seeds, rows = e["bufs"]["meta"][0], e["bufs"]["meta"][1]
        counters = sg.noise_counters(sum(e["sizes"]), "cuda")
        bits = sg.row_noise_bits(seeds, rows, counters).cpu()
        if not torch.equal(bits, sg.row_noise_bits(
                seeds.cpu(), rows.cpu(), counters.cpu())):
            raise AssertionError(f"serve {key}: card and CPU noise streams "
                                 "differ")
        del bits, counters

    # times (CUDA events after the 2 GiB flush; host clock for enqueue)
    out = e["fn"]()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    args = e["args"]
    moved = srv.modeled_slab_bytes()
    drawn = draw_floor_bytes(e, post.icr.policy.storage_dtype)
    cast = (0 if post.icr.policy.storage_dtype == torch.float32 else
            out.numel() * (torch.finfo(post.icr.policy.storage_dtype).bits
                           // 8 + out.element_size()))
    batch = out.cpu().numpy()      # one slab's fields on the host
    state = sg._welford_merge(0, None, None, batch)
    welford = []
    for _ in range(REPS // 5):
        t0 = time.perf_counter()
        sg._welford_merge(*state, batch)
        welford.append((time.perf_counter() - t0) * 1e3)
    record = {
        "slab_graph_ms": time_ms(e["fn"], flush),
        "slab_eager_ms": time_ms(lambda: e["slab_fn"](*args), flush),
        "host_graph_ms": enqueue_ms(e["fn"]),
        "host_eager_ms": enqueue_ms(lambda: e["slab_fn"](*args)),
        "draw_ms": time_ms(lambda: e["draw"](*args), flush),
        "d2h_ms": time_ms(lambda: host.copy_(out, non_blocking=True), flush),
        "welford_ms": statistics.median(welford),
        "cold_ms": cold_ms, "warm_ms": warm_s * 1e3,
        "rows_per_s": (srv.rows_served - rows0) / warm_s,
        "slabs_warm": m["slabs_run"] - slabs0, "route": srv.route,
        "modeled_slab_bytes": moved,
        "bound_ms": moved / bandwidth * 1e3,
        "draw_floor_bytes": drawn,
        "draw_bound_ms": drawn / bandwidth * 1e3,
        "cast_bytes": cast,
        "slab_bound_ms": (moved + drawn + cast) / bandwidth * 1e3,
        "field_bytes": out.numel() * out.element_size(),
        "graph_kernel_nodes": dict(nodes),
        "eager_vs_plain_rel": rel_plain,
        "cache": {k: m[k] for k in ("cache_hits", "cache_misses",
                                    "graph_captures")},
        "card": card}
    del srv, e, out, host, xi, eager, graph_out, batch, state
    torch.cuda.empty_cache()
    return launches, record


def check_serve(flush, bandwidth, card) -> tuple:
    """Phase 5: the server on the four charts at both dtype policies."""
    launches = {k: 0 for k in KERNEL_INFO}
    records = {}
    for cname, (chart, kernel) in charts().items():
        for pol in (None, "bf16"):
            counts, rec = serve_case(cname, chart,
                                     kernel.default_theta["rho"], pol,
                                     flush, bandwidth, card)
            for k, n in counts.items():
                launches[k] += n
            records[f"{cname}-{pol or 'fp32'}"] = rec
    return launches, records


# the condition phase: the entry-point solve's on-grid observations (the
# dense rung's dense_max, so the whole ladder is available), its noise (the
# CG example's default), the matvec batch timed beside k = 1 (the mean and
# 16 Matheron columns of a served request), and the charts served
COND_OBS = 4096
COND_NOISE = 0.25
COND_K = 17
COND_SERVED = ("dust", "regular")
# the served and the entry point's mean fields against each other and
# against the float64 posterior mean of the same system (``mean64``):
# 10x the largest reading of a sound run, 1.8e-5 (dust; both solves end
# on the dense rung; NVIDIA H100 80GB HBM3 at 700 W, PERF.md §5).
# The float32 correction K Wᵀ α sums Sᵀ over Wᵀα's cancelling entries in
# float32: from the exact α it sits 2.8e-6 (dust) and 7.9e-6 (regular)
# from the float64 mean, and α's own float32 floor adds to that, so two
# float32 means of one system do not meet 1e-5 on dust
COND_MEAN_F64 = 2e-4


def plain_correct(icr, mats, op, v):
    """``ConditionSystem.correct`` (K Wᵀ v, the fields) with every kernel
    replaced by its plain version, on the same device: Sᵀ by autograd
    through ``plain_apply`` at zero ξ (the map is linear in ξ), then
    ``plain_apply``."""
    import torch

    k = v.shape[0]
    u = op.apply_t(v).reshape((k,) + tuple(icr.chart.final_shape))
    zero = [torch.zeros((k,) + tuple(s), dtype=mats["sqrt0"].dtype,
                        device=v.device, requires_grad=True)
            for s in icr.xi_shapes()]
    with torch.enable_grad():
        f = plain_apply(icr, mats, zero)
        xi = torch.autograd.grad(f, zero, grad_outputs=u.to(f.dtype))
    with torch.no_grad():
        return plain_apply(icr, mats, list(xi)).reshape(k, -1)


def plain_matvec(icr, mats, op, noise_var, v):
    """``condition_matvec`` on the plain versions."""
    return (op.apply(plain_correct(icr, mats, op, v)).to(v.dtype)
            + noise_var * v)


def residuals64(icr, mats, mats64, op, noise_var, x, y, matvec,
                rtol, cap: float = 0.0) -> dict:
    """The residual ‖y − A64 x‖/‖y‖ of a float32 solution `x` (1, n_obs),
    A64 applied through the plain versions at float64, beside δ =
    ‖A32 x − A64 x‖/‖y‖, the float32 kernel-route operator's (`matvec`)
    own distance from A64 at x, and the bound 10·max(rtol, δ), δ capped
    at `cap` where the solve's ``CGConfig.floor_cap`` is above 0 (so the
    bound is at most 10·cap and x = 0, whose residual is 1, fails it).
    A64 is built two
    ways: from the solve's own float32 matrices at float64 (``same``, the
    checked one: δ is then the rounding of one float32 matvec at x, the
    floor under which no float32 solution holds its residual) and, for
    the record, from matrices built at float64 (``built_f64``: δ also
    holds the two builds' difference, up to percent on reflect charts,
    ROADMAP queue 3)."""
    import torch

    from repro_torch.kernels.policy import cast_tree

    yd = y.reshape(1, -1).double()
    ny = float(torch.linalg.vector_norm(yd))
    with torch.no_grad():
        a32 = matvec(x).double()
    out = {}
    for key, m in (("same", cast_tree(mats, torch.float64)),
                   ("built_f64", mats64)):
        with torch.no_grad():
            a64 = plain_matvec(icr, m, op, noise_var, x.double())
        delta = float(torch.linalg.vector_norm(a32 - a64)) / ny
        held = min(delta, cap) if cap > 0 else delta
        out[key] = {"residual": float(torch.linalg.vector_norm(a64 - yd))
                    / ny, "delta": delta, "bound": 10 * max(rtol, held)}
    return out


def mean64(system, mats, alpha, y, steps=3):
    """The posterior mean field K Wᵀ α64 at float64 on the solve's own
    matrices: α64 solves A64 α = y (A64 the plain versions at float64),
    reached by iterative refinement from the float32 `alpha` with the
    dense rung's matrix as the approximate inverse (‖A⁻¹(A64 − A)‖ is the
    float32 rounding). Returns ``(field, ‖y − A64 α64‖/‖y‖, α64)``."""
    import torch

    from repro_torch.kernels.policy import cast_tree

    icr, op, nv = system.icr, system.obs, system.noise_var
    m64 = cast_tree(mats, torch.float64)
    yd = y.reshape(1, -1).double()
    lu = torch.linalg.lu_factor(
        system.dense_matrix(torch.float32, y.device).double())
    a = alpha.double()
    for _ in range(steps):
        r = yd - plain_matvec(icr, m64, op, nv, a)
        a = a + torch.linalg.lu_solve(*lu, r.T).T
    res = float(torch.linalg.vector_norm(
        yd - plain_matvec(icr, m64, op, nv, a))
        / torch.linalg.vector_norm(yd))
    return plain_correct(icr, m64, op, a).reshape(-1), res, a


def condition_reaches(chart, samples) -> set:
    """The kernels a matvec at `samples` columns launches: the forward's
    per level (the pyramid over its cover), and the adjoints of every
    level (``apply_sqrt_T_batch`` runs no pyramid)."""
    from repro_torch.kernels import dispatch

    plan = dispatch.plan(chart, pyramid=True, samples=samples)
    return ({e["kernel"] for e in plan if e["launches"]}
            | {v["kernel"] for e in plan for v in e["vjp"]})


def condition_case(cname, chart, kernel, flush, card,
                   device="cuda") -> tuple:
    """Phase 6 on one chart, float32: (a) ``cg_posterior`` on 4,096
    seeded on-grid observations of a prior draw at σ = 0.25 at its
    default config, its residual recomputed at float64 through the plain
    versions, then at the JAX package's rtol 1e-7 (the dense rung's α);
    both solves again with their CG segments replayed and op by op, bit
    for bit, and one CG iteration's ms each way; (b) the kernel route's
    matvec against the plain route at k = 17, f32 and bf16; on dust and
    regular (c) one served ``kind="condition"`` request (n = 16) at rtol
    1e-7 whose mean is held to (a)'s and to the float64 posterior mean,
    (e) ``cg_posterior`` and a served request at their default configs on
    the training data's pattern (314,572 observations), and (d) the ICR
    rung at the level-0 basis against the unpreconditioned rung on that
    pattern. Returns ``(launches, record)``."""
    import numpy as np
    import torch

    from repro_torch import ICR, cg_posterior, charted_gp_dataset
    from repro_torch.kernels import build
    from repro_torch.launch import serve_gp as sg
    from repro_torch.solvers import CGConfig, condition_matvec, solve_guarded

    sync = (torch.cuda.synchronize if device == "cuda" else lambda: None)
    post = sg.demo_posterior(chart, kernel.default_theta["rho"],
                             device=device)
    icr = post.icr
    mats = icr.matrices_cached()
    mats64 = icr.matrices(dtype=torch.float64)
    srv = (sg.GPFieldServer(post, slab=S) if cname in COND_SERVED
           else None)
    gen = torch.Generator(device=device).manual_seed(31)
    truth = icr.sample(gen).reshape(-1)
    n_obs = min(COND_OBS, truth.numel() // 2)
    obs = torch.sort(torch.randperm(truth.numel(), generator=gen,
                                    device=device)[:n_obs]).values
    y = truth[obs].float() + COND_NOISE * torch.randn(
        n_obs, generator=gen, device=device)
    obs_np = obs.cpu().numpy()
    noise_var = COND_NOISE ** 2
    launches = {k: 0 for k in KERNEL_INFO}

    def reached(window, samples):
        counts = {k: build.LAUNCHES[k] for k in KERNEL_INFO}
        missing = sorted(k for k in condition_reaches(chart, samples)
                         if counts[k] == 0)
        if missing:
            raise AssertionError(f"condition {cname} {window}: kernels "
                                 f"never launched: {missing} ({counts})")
        for k, n in counts.items():
            launches[k] += n

    # (a) the entry point at its default config (rtol from the matvec's
    # rounding), the launch counters zeroed just before; the residual of
    # its own α, recomputed at float64 through the plain versions on the
    # solve's own matrices
    sync()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    solution = {}
    _, rep = cg_posterior(icr, obs_np, y, noise_std=COND_NOISE,
                          _solution=solution)
    sync()
    solve_ms = (time.perf_counter() - t0) * 1e3
    reached("cg_posterior", 1)
    if rep.status[0] not in ("converged", "dense"):
        raise AssertionError(f"condition {cname}: cg_posterior ended "
                             f"{rep.summary()}")
    system, alpha = solution["system"], solution["alpha"]
    op = system.obs
    residuals = residuals64(icr, mats, mats64, op, noise_var, alpha, y,
                            system.matvec, rep.rtol, rep.floor_cap)
    if not (residuals["same"]["residual"] <= residuals["same"]["bound"]
            < 1.0 and rep.floor_cap > 0 and rep.delta is not None):
        raise AssertionError(f"condition {cname}: float64 residual "
                             f"{residuals}, report {rep.summary()}")

    # the same solve at the JAX package's rtol 1e-7, under float32's floor:
    # the CG rungs stall and the dense rung answers at float64; the mean
    # fields are held with this α
    tight = cond_tight(n_obs)
    sol_t = {}
    post_t, rep_t = cg_posterior(icr, obs_np, y, noise_std=COND_NOISE,
                                 config=tight, _solution=sol_t)
    residuals_t = residuals64(icr, mats, mats64, op, noise_var,
                              sol_t["alpha"], y, system.matvec, tight.rtol)
    if (rep_t.status[0] not in ("converged", "dense")
            or not (residuals_t["same"]["residual"]
                    <= residuals_t["same"]["bound"])):
        raise AssertionError(f"condition {cname}: cg_posterior at rtol "
                             f"1e-7 ended {rep_t.summary()}, float64 "
                             f"residual {residuals_t}")
    with torch.no_grad():
        mean_a = icr.apply_sqrt(mats, post_t.mean).reshape(-1)

    # graphed CG segments against eager ones: both solves again, bit for
    # bit; one CG iteration's ms and a segment's enqueue at k = 1 and 17
    yb = y.reshape(1, -1)
    graphed = {"default": graph_vs_eager(system, yb, solution["cfg"],
                                         cname, sync),
               "rtol_1e-7": graph_vs_eager(system, yb, tight, cname, sync)}
    vk = torch.randn((COND_K, n_obs), generator=gen, device=device)
    for b in (yb, vk):
        graphed[f"k{b.shape[0]}"] = cg_iteration_ms(system, b, flush)

    # matvec times by CUDA events, k = 1 and 17, and one matvec's enqueue
    v1 = torch.randn((1, n_obs), generator=gen, device=device)
    times = {"matvec_k1_ms": time_ms(lambda: system.matvec(v1), flush),
             f"matvec_k{COND_K}_ms": time_ms(lambda: system.matvec(vk),
                                             flush),
             "matvec_k1_enqueue_ms": enqueue_ms(lambda: system.matvec(v1))}

    # (b) the kernel route's matvec against the plain route, same matrices
    parity = {}
    icr_bf = ICR(chart, icr.kernel, use_pallas=True, dtype_policy="bf16",
                 device=device)
    for key, ic, m in (("fp32", icr, mats),
                       ("bf16", icr_bf, icr_bf.matrices())):
        with torch.no_grad():
            got = condition_matvec(ic, m, op, noise_var, vk)
        _, parity[key] = rel_err(got, plain_matvec(ic, m, op, noise_var, vk))
        tol = TOL["float32" if key == "fp32" else "bfloat16"]
        if not parity[key] <= tol:
            raise AssertionError(f"condition {cname} {key}: matvec against "
                                 f"the plain route {parity[key]:.3g} > {tol}")
    del icr_bf
    record = {"chart": cname, "n_obs": n_obs, "noise_std": COND_NOISE,
              "rtol": rep.rtol, "floor_cap": rep.floor_cap,
              "delta": rep.delta,
              "precond_bytes": getattr(system.precond, "nbytes", 0),
              "report": rep.summary(), "relres_reported": rep.relres[0],
              "solve_ms": solve_ms, "residual_f64": residuals,
              "report_rtol_1e-7": rep_t.summary(),
              "residual_f64_rtol_1e-7": residuals_t, "graphs": graphed,
              **times, "matvec_vs_plain_rel": parity}

    if srv is not None:
        # (c) one served request on (a)'s system at rtol 1e-7 (column 0 y,
        # 16 Matheron columns): its mean against (a)'s, and both against
        # the float64 posterior mean of the same system and matrices
        srv.solver_config = tight
        req = sg.GPRequest(kind="condition", n=COND_K - 1, seed=5,
                           y=y.cpu().numpy(), obs_idx=obs_np,
                           noise_std=COND_NOISE)
        sync()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        srv.run([req])
        sync()
        served_ms = (time.perf_counter() - t0) * 1e3
        reached("served", COND_K)
        if not req.done or req.error is not None:
            raise AssertionError(f"condition {cname}: served request "
                                 f"failed: {req.error}")

        def rel2(got, want):
            got = torch.as_tensor(got, device=device).reshape(-1).double()
            want = want.reshape(-1).double()
            return float(torch.linalg.vector_norm(got - want)
                         / torch.linalg.vector_norm(want))

        want, res64, alpha64 = mean64(system, mats, sol_t["alpha"], y)
        with torch.no_grad():
            # the float32 correction alone, from the float64 α
            corr = system.correct(alpha64.float()).reshape(-1)
        served = {"ms": served_ms,
                  "correct_f32_of_alpha64_vs_f64": rel2(corr, want),
                  "mean_vs_cg_posterior": rel2(req.mean, mean_a),
                  "mean_vs_f64": rel2(req.mean, want),
                  "cg_posterior_vs_f64": rel2(mean_a, want),
                  "f64_residual": res64,
                  "std_mean": float(np.mean(req.std)),
                  "report": req.report.summary()}
        reports = srv.metrics()["solve_reports"]
        if (not served["mean_vs_cg_posterior"] <= COND_MEAN_F64
                or not served["mean_vs_f64"] <= COND_MEAN_F64
                or not served["cg_posterior_vs_f64"] <= COND_MEAN_F64
                or not np.isfinite(req.std).all() or not reports
                or reports[-1] != req.report.summary()):
            raise AssertionError(f"condition {cname}: served {served}, "
                                 f"finite std "
                                 f"{bool(np.isfinite(req.std).all())}, "
                                 f"reports {len(reports)}")
        record["served"] = served
        srv.solver_config = None

        # (e) on the training data's pattern (30 %, σ = 0.05: 314,572
        # observations), past the dense rung's reach: cg_posterior and a
        # served request at their default configs must answer, α's float64
        # residual within 10·max(rtol, δ), the report stating both
        gen.manual_seed(21)
        _, obs_d, y_d = charted_gp_dataset(icr, gen, obs_frac=OBS_FRAC,
                                           noise_std=NOISE)
        obs_d_np = obs_d.cpu().numpy()
        sync()
        t0 = time.perf_counter()
        sol_e = {}
        _, rep_e = cg_posterior(icr, obs_d_np, y_d, noise_std=NOISE,
                                _solution=sol_e)
        sync()
        ms_e = (time.perf_counter() - t0) * 1e3
        sys_d = sol_e["system"]
        op_d = sys_d.obs
        res_e = residuals64(icr, mats, mats64, op_d, NOISE ** 2,
                            sol_e["alpha"], y_d, sys_d.matvec, rep_e.rtol,
                            rep_e.floor_cap)
        held0 = torch.cuda.memory_allocated() if device == "cuda" else 0
        req_e = sg.GPRequest(kind="condition", n=COND_K - 1, seed=7,
                             y=y_d.cpu().numpy(), obs_idx=obs_d_np,
                             noise_std=NOISE)
        sync()
        t0 = time.perf_counter()
        srv.run([req_e])
        sync()
        served_sys = list(srv._cond_cache.values())
        default = {"n_obs": op_d.n_obs, "solve_ms": ms_e,
                   "report": rep_e.summary(), "residual_f64": res_e,
                   "served_ms": (time.perf_counter() - t0) * 1e3,
                   # device memory: the entry point's system (U and the
                   # factor of its preconditioner), and what the served
                   # request's cached system added on the card
                   "precond_bytes": getattr(sys_d.precond, "nbytes", 0),
                   "served_systems": len(served_sys),
                   "served_precond_bytes": sum(
                       getattr(q.precond, "nbytes", 0) for q in served_sys),
                   "served_added_bytes": (
                       torch.cuda.memory_allocated() - held0
                       if device == "cuda" else 0),
                   "served_segment_graphs": sum(
                       len(q.graphs) for q in served_sys),
                   "served_error": (None if req_e.error is None
                                    else req_e.error.code),
                   "served_report": (req_e.report.summary()
                                     if req_e.report is not None else None)}
        record["default_314k"] = default
        if (rep_e.status[0] not in ("converged", "dense")
                or not (res_e["same"]["residual"]
                        <= res_e["same"]["bound"] < 1.0)
                or rep_e.floor_cap <= 0 or rep_e.delta is None
                or not req_e.done or req_e.error is not None
                or req_e.report.delta is None):
            raise AssertionError(f"condition {cname}: the default solve "
                                 f"on {op_d.n_obs} observations: {default}")

        # (d) the ICR rung at the level-0 basis (the default system's
        # preconditioner) against the unpreconditioned rung on that pattern
        level0 = icr.xi_shapes()[0][0]
        rungs = {"n_obs": op_d.n_obs, "basis": level0}
        cfg_d = CGConfig(max_iters=500)
        for name, pc in (("icr", sys_d.precond), ("none", None)):
            t0 = time.perf_counter()
            x, rep_d = solve_guarded(sys_d.matvec, y_d[None],
                                     preconds=[(name, pc)], cfg=cfg_d,
                                     tag=f"rung:{name}",
                                     segment_graphs=sys_d.graphs)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            res_d = residuals64(icr, mats, mats64, op_d, NOISE ** 2, x,
                                y_d, sys_d.matvec, cfg_d.rtol)
            if rep_d.status[0] == "converged" and not (
                    res_d["same"]["residual"] <= 10 * cfg_d.rtol):
                raise AssertionError(
                    f"condition {cname} rung {name}: reports converged "
                    f"with float64 residuals {res_d}")
            rungs[name] = {"iterations": rep_d.iterations[0],
                           "status": rep_d.status[0],
                           "relres_reported": rep_d.relres[0],
                           "residual_f64": res_d, "solve_ms": ms}
        record["icr_rung"] = rungs
        del sys_d, sol_e
    record["card"] = card
    del srv, post, mats64, system, solution, sol_t
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches, record


def cond_tight(n_obs: int):
    """The JAX package's default ``CGConfig`` (rtol 1e-7): under float32's
    floor at full width, so every CG rung stalls and, up to ``dense_max``
    observations, the dense rung answers at float64."""
    from repro_torch.solvers import CGConfig

    return CGConfig(rtol=1e-7, max_iters=max(4 * n_obs, 200))


def graph_vs_eager(system, b, cfg, tag, sync) -> dict:
    """One solve of `b` on `system` down its ladder at `cfg`, its CG
    segments replayed from the system's captured graphs and then run op by
    op: the wall ms of each, and status, iterations and x, which must
    agree bit for bit (the on-grid matvec is deterministic)."""
    from repro_torch.core import graphs
    from repro_torch.solvers import solve_guarded

    ladder = ([("icr", system.precond)] if system.precond is not None
              else []) + [("none", None)]
    out, runs = {}, {}
    for name, mode in (("graph", contextlib.nullcontext),
                       ("eager", graphs.eager)):
        sync()
        t0 = time.perf_counter()
        with mode():
            runs[name] = solve_guarded(
                system.matvec, b, preconds=ladder, cfg=cfg,
                dense_solve=system.dense_solve, tag=tag,
                segment_graphs=system.graphs)
        sync()
        out[f"solve_{name}_ms"] = (time.perf_counter() - t0) * 1e3
    (xg, rg), (xe, re_) = runs["graph"], runs["eager"]
    out.update(rungs=list(rg.rungs), status=list(rg.status),
               iterations=list(rg.iterations),
               graph_equals_eager=(rg.status == re_.status
                                   and rg.iterations == re_.iterations
                                   and same_bits(xg, xe)))
    if not out["graph_equals_eager"]:
        raise AssertionError(f"condition {tag}: the graphed solve differs "
                             f"from the eager one: {rg.summary()} against "
                             f"{re_.summary()}")
    return out


def cg_iteration_ms(system, b, flush) -> dict:
    """Milliseconds of one CG iteration on the system's first rung at
    ``b.shape[0]`` columns (CUDA events over a segment of ``pcg.SEGMENT``
    iterations, divided), replayed from its captured graph and op by op,
    with the host time to enqueue a segment each way."""
    from repro_torch.core import graphs
    from repro_torch.solvers import CGConfig, pcg

    cfg = CGConfig(rtol=1e-7, max_iters=10**9)
    carry = pcg._pcg_init(system.matvec, b, system.precond, cfg)
    out = {"rung": "none" if system.precond is None else "icr"}
    for name, mode in (("graph", contextlib.nullcontext),
                       ("eager", graphs.eager)):
        runner = pcg._iterations(system.matvec, system.precond, cfg, carry,
                                 {})

        def segment(runner=runner, mode=mode):
            with mode():
                runner.advance(pcg.SEGMENT)

        out[f"iteration_{name}_ms"] = time_ms(segment, flush) / pcg.SEGMENT
        out[f"segment_{name}_enqueue_ms"] = enqueue_ms(segment)
    return out


def check_condition(flush, card) -> dict:
    """Phase 6: the data-conditioned solve on the four charts; one
    ``condition`` line per chart. Returns the launches."""
    import torch

    launches = {k: 0 for k in KERNEL_INFO}
    for cname, (chart, kernel) in charts().items():
        counts, rec = condition_case(cname, chart, kernel, flush, card)
        for k, n in counts.items():
            launches[k] += n
        # what the card still holds once the chart's systems, server and
        # graphs are dropped
        rec["allocated_after_bytes"] = torch.cuda.memory_allocated()
        rec["reserved_after_bytes"] = torch.cuda.memory_reserved()
        print("condition: " + json.dumps(rec), flush=True)
    return launches


# -- phase 7: distributed ICR, the mesh modes and the RHS-sharded solve ------
DIST_SLOTS = 8
# chart -> shard axis of the sharded apply; the log chart's reflect twin
# stands in for the script's log chart, whose "shrink" boundary
# DistributedICR refuses (it runs #3 sharded, per-family matrices sliced)
DIST_AXES = {"dust": 1, "regular": 0, "log_polar": 0, "log_reflect": 0}
DIST_SERVED = ("dust", "regular")
# (chart, dtype) -> the launches and halo bytes of the sharded apply
DIST_DRY: dict = {}


def dist_mesh(axis: str, device="cuda"):
    """``DIST_SLOTS`` slots over the visible cards, repeated where there
    are fewer (a virtual mesh on one card); `device` "cpu" (a rehearsal
    on the CPU) repeats the CPU."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    cards = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if device == "cuda" else [torch.device(device)])
    return make_mesh((DIST_SLOTS,), (axis,),
                     devices=[cards[i % len(cards)]
                              for i in range(DIST_SLOTS)])


@contextlib.contextmanager
def plain_guard(window: str, device="cuda"):
    """Within the block every plain version of the forward kernels counts
    its calls (they must stay at 0 on the card: a CUDA tensor launches
    the kernel; on the CPU they are what runs)."""
    from repro_torch.kernels import icr_refine, nd_fused

    names = [(icr_refine, n) for n in (
        "refine_stationary_plain", "refine_charted_plain",
        "refine_stationary_nn_plain", "refine_charted_nn_plain")]
    names.append((nd_fused, "refine_nd_fused_plain"))
    calls = collections.Counter()
    saved = [(mod, n, getattr(mod, n)) for mod, n in names]

    def counting(n, fn):
        def run(*a, **k):
            calls[n] += 1
            return fn(*a, **k)
        return run

    for mod, n, fn in saved:
        setattr(mod, n, counting(n, fn))
    try:
        yield calls
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    if calls and device == "cuda":
        raise AssertionError(f"distributed {window}: plain versions ran "
                             f"{dict(calls)}")


def _sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def dist_apply_case(cname, chart, kernel, mats32, flush, gen,
                    device="cuda") -> tuple:
    """The sharded apply on one chart at S = 8, f32 and bf16: against the
    unsharded kernel route (``ICR.apply_sqrt_batch``), launches per
    kernel, device and enqueue ms each way, halo bytes per level. Returns
    ``(launches, record)``."""
    import torch

    from repro_torch import ICR
    from repro_torch.core.distributed import HALO_BYTES, DistributedICR
    from repro_torch.core.refine import LevelGeom
    from repro_torch.kernels import build, dispatch

    axis = DIST_AXES[cname]
    launches = collections.Counter()
    record = {"shard_axis": axis}
    for pol in (None, "bf16"):
        dname = "float32" if pol is None else "bfloat16"
        icr = ICR(chart, kernel, use_pallas=True, dtype_policy=pol,
                  device=device)
        mats = (mats32 if pol is None and mats32 is not None
                else icr.matrices())
        dist = DistributedICR(icr, dist_mesh("space", device),
                              shard_axis=axis)
        k = dist.first_sharded_level()
        placed = dist.place(mats)
        xi = icr.init_xi(gen.manual_seed(11), batch=S)
        _sync(device)
        build.LAUNCHES.clear()
        HALO_BYTES[0] = 0
        with plain_guard(f"{cname} {dname}", device):
            blocks = dist.apply_sqrt_batch(placed, xi)
            _sync(device)
        counts = +collections.Counter(build.LAUNCHES)
        # what the dry run must predict from the geometry (phase 12d)
        DIST_DRY[(cname, dname)] = {"chart": chart, "axis": axis,
                                    "launches": dict(counts),
                                    "halo_bytes_moved": HALO_BYTES[0]}
        launches.update(counts)
        devices = len({s.device for s in dist.ring()})
        want = collections.Counter()
        for lvl in range(chart.n_levels):
            geom = LevelGeom.for_level(chart, lvl)
            kname = dispatch.KERNEL_OF_ROUTE[dispatch.route_for(
                geom, have_axis_mats=chart.ndim > 1)]
            want[kname] += devices if lvl < k else DIST_SLOTS
        if device == "cuda" and counts != want:
            raise AssertionError(f"distributed {cname} {dname}: launches "
                                 f"{dict(counts)}, want {dict(want)}")
        got = dist.gather(blocks)
        ref = icr.apply_sqrt_batch(mats, xi)
        _, rel = rel_err(got, ref)
        if not rel <= TOL[dname]:
            raise AssertionError(f"distributed {cname} {dname}: sharded "
                                 f"against unsharded {rel:.3g} > "
                                 f"{TOL[dname]}")
        itemsize = torch.finfo(icr.policy.storage_dtype).bits // 8
        record[dname] = {
            "first_sharded_level": k, "max_rel_err": rel,
            "bits_equal": bool(torch.equal(got, ref)),
            "launches": dict(counts),
            "sharded_ms": time_ms(
                lambda: dist.apply_sqrt_batch(placed, xi), flush),
            "unsharded_ms": time_ms(
                lambda: icr.apply_sqrt_batch(mats, xi), flush),
            "sharded_enqueue_ms": enqueue_ms(
                lambda: dist.apply_sqrt_batch(placed, xi)),
            "unsharded_enqueue_ms": enqueue_ms(
                lambda: icr.apply_sqrt_batch(mats, xi)),
            "halo_bytes": [dist.halo_bytes(lvl, S, itemsize)
                           for lvl in range(k, chart.n_levels)],
            "halo_bytes_moved": DIST_DRY[(cname, dname)][
                "halo_bytes_moved"]}
        del blocks, got, ref, placed, xi
    return launches, record


def dist_serve_case(cname, chart, kernel, card, device="cuda") -> tuple:
    """``mixed_requests(3, 16)`` served on 8 slots: samples mode (slab 2 a
    slot) bit for bit against the unsharded server at slab 2; chart mode
    (slab 8) within 1e-5 of the unsharded server at slab 8; samples mode
    with a ``KillDevice`` at the second slab attempt: one re-plan, one
    cache miss, the replayed rows bit for bit the unfaulted run's. The
    launch counters cover the three sharded servers. Returns
    ``(launches, record)``."""
    import numpy as np
    import torch

    from repro_torch.distributed import chaos
    from repro_torch.kernels import build
    from repro_torch.launch import serve_gp as sg

    post = sg.demo_posterior(chart, kernel.default_theta["rho"],
                             device=device)

    def served(srv):
        reqs = sg.mixed_requests(3, 16)
        _sync(device)
        t0 = time.perf_counter()
        srv.run(reqs)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        out = []
        for r in reqs:
            if not r.done or r.error is not None:
                raise AssertionError(f"distributed serve {cname}: request "
                                     f"failed: {r.error}")
            out.extend(r.fields if r.kind == "sample" else [r.mean, r.std])
        return out, ms

    base2, _ = served(sg.GPFieldServer(post, slab=2))
    base8, _ = served(sg.GPFieldServer(post, slab=8))
    _sync(device)
    build.LAUNCHES.clear()
    with plain_guard(f"serve {cname}", device):
        samples = sg.GPFieldServer(post, slab=2,
                                   mesh=dist_mesh("data", device))
        got_s, ms_s = served(samples)
        chart_srv = sg.GPFieldServer(post, slab=8,
                                     mesh=dist_mesh("space", device),
                                     shard="chart")
        got_c, ms_c = served(chart_srv)
        inj = chaos.ChaosInjector([chaos.KillDevice(at_slab=1,
                                                    device_indices=(3,))])
        killed = sg.GPFieldServer(post, slab=2,
                                  mesh=dist_mesh("data", device),
                                  fault_injector=inj)
        got_k, ms_k = served(killed)
    launches = +collections.Counter(build.LAUNCHES)
    bits_s = all(np.array_equal(a, b) for a, b in zip(got_s, base2))
    bits_k = all(np.array_equal(a, b) for a, b in zip(got_k, got_s))
    chart_rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                    for a, b in zip(got_c, base8))
    mk = killed.metrics()
    ms = samples.metrics()
    record = {
        "samples_mode": ms["mode"], "chart_mode": chart_srv.serving_mode,
        "samples_bits_equal": bits_s, "chart_max_rel_err": chart_rel,
        "kill_bits_equal": bits_k, "kill_replans": mk["replans"],
        "kill_cache_misses": mk["cache_misses"],
        "kill_replayed_slabs": mk["replayed_slabs"],
        "kill_mesh": mk["mesh"], "kill_recovery_s": mk["last_recovery_s"],
        "graph_captures_samples": ms["graph_captures"],
        "samples_cold_ms": ms_s, "chart_cold_ms": ms_c, "kill_ms": ms_k,
        "launches": dict(launches), "card": card}
    if not (bits_s and bits_k and chart_rel <= TOL["float32"] and inj.fired
            and mk["replans"] == 1 and mk["cache_misses"] == 2
            and mk["replayed_slabs"] >= 1
            and killed.mesh.size == DIST_SLOTS - 1
            and ms["mode"] == f"sharded-samples:{device}-"
            f"{'graph' if device == 'cuda' else 'eager'}"
            and ms["graph_captures"] == (DIST_SLOTS if device == "cuda"
                                         else 0)):
        raise AssertionError(f"distributed serve {cname}: {record}")
    del samples, chart_srv, killed, post
    return launches, record


def dist_condition(chart, kernel, card, device="cuda") -> tuple:
    """``cg_posterior(mesh=)`` on 8 slots at 4,096 observations (σ =
    0.25) of a prior draw, default config: α against the unsharded solve's
    within 10·max(rtol, δ) (δ capped at the report's ``floor_cap``), and
    the mean field within ``COND_MEAN_F64`` of the float64 posterior mean
    of the same system. Returns ``(launches, record)``."""
    import torch

    from repro_torch import cg_posterior
    from repro_torch.kernels import build
    from repro_torch.launch import serve_gp as sg

    post = sg.demo_posterior(chart, kernel.default_theta["rho"],
                             device=device)
    icr = post.icr
    mats = icr.matrices_cached()
    gen = torch.Generator(device=device).manual_seed(31)
    truth = icr.sample(gen).reshape(-1)
    n_obs = min(COND_OBS, truth.numel() // 2)
    obs = torch.sort(torch.randperm(truth.numel(), generator=gen,
                                    device=device)[:n_obs]).values
    y = truth[obs].float() + COND_NOISE * torch.randn(
        n_obs, generator=gen, device=device)
    obs_np = obs.cpu().numpy()
    sol0 = {}
    cg_posterior(icr, obs_np, y, noise_std=COND_NOISE, _solution=sol0)
    _sync(device)
    build.LAUNCHES.clear()
    sol = {}
    t0 = time.perf_counter()
    with plain_guard("cg_posterior", device):
        post_s, rep = cg_posterior(icr, obs_np, y, noise_std=COND_NOISE,
                                   mesh=dist_mesh("data", device),
                                   _solution=sol)
        _sync(device)
    solve_ms = (time.perf_counter() - t0) * 1e3
    launches = +collections.Counter(build.LAUNCHES)
    a, a0 = sol["alpha"].double(), sol0["alpha"].double()
    alpha_rel = float(torch.linalg.vector_norm(a - a0)
                      / torch.linalg.vector_norm(a0))
    delta = rep.delta if rep.delta is not None else 0.0
    held = min(delta, rep.floor_cap) if rep.floor_cap > 0 else delta
    bound = 10 * max(rep.rtol, held)
    want, res64, _ = mean64(sol0["system"], mats, sol0["alpha"], y)
    with torch.no_grad():
        mean = icr.apply_sqrt(mats, post_s.mean).reshape(-1).double()
    mean_rel = float(torch.linalg.vector_norm(mean - want)
                     / torch.linalg.vector_norm(want))
    record = {"n_obs": n_obs, "noise_std": COND_NOISE,
              "report": rep.summary(), "solve_ms": solve_ms,
              "alpha_rel_vs_unsharded": alpha_rel, "alpha_bound": bound,
              "alpha_bits_equal": bool(torch.equal(sol["alpha"],
                                                   sol0["alpha"])),
              "mean_vs_f64": mean_rel, "f64_residual": res64,
              "launches": dict(launches), "card": card}
    if not (rep.status[0] in ("converged", "dense") and alpha_rel <= bound
            and mean_rel <= COND_MEAN_F64
            and (launches or device != "cuda")):
        raise AssertionError(f"distributed cg_posterior: {record}")
    del sol, sol0, post_s, post
    return launches, record


def check_distributed(models, flush, gen, card, device="cuda",
                      charts7=None) -> dict:
    """Phase 7: the sharded apply on four charts, the two mesh modes and a
    killed slot on dust and regular, and ``cg_posterior(mesh=)`` on dust;
    one ``distributed`` line. Returns the launches. (`device` and
    `charts7`, {name: (chart, kernel, f32 matrices or None)}, let a
    rehearsal run it on the CPU at small charts.)"""
    import torch

    from repro_torch import log_chart, matern32

    t0 = time.perf_counter()
    mesh = dist_mesh("space", device)
    record = {"slots": DIST_SLOTS,
              "devices": len(mesh.distinct_devices()), "samples": S,
              "card": card, "apply": {}, "serve": {}}
    if charts7 is None:
        charts7 = {c: (models[c][0].chart, models[c][0].kernel,
                       models[c][1])
                   for c in ("dust", "regular", "log_polar")}
        charts7["log_reflect"] = (
            log_chart(1024, 8, n_csz=5, n_fsz=4, delta0=0.0197 / 16,
                      boundary="reflect"), matern32.with_defaults(rho=1.0),
            None)
    launches = collections.Counter()
    for cname, (chart, kernel, mats) in charts7.items():
        counts, rec = dist_apply_case(cname, chart, kernel, mats, flush, gen,
                                      device)
        launches.update(counts)
        record["apply"][cname] = {"points": chart.size, **rec}
        if device == "cuda":
            torch.cuda.empty_cache()
    for cname in DIST_SERVED:
        chart, kernel, _ = charts7[cname]
        counts, rec = dist_serve_case(cname, chart, kernel, card, device)
        launches.update(counts)
        record["serve"][cname] = rec
    chart, kernel, _ = charts7["dust"]
    counts, record["cg_posterior"] = dist_condition(chart, kernel, card,
                                                    device)
    launches.update(counts)
    record["seconds"] = time.perf_counter() - t0
    print("distributed: " + json.dumps(record), flush=True)
    return {k: launches[k] for k in KERNEL_INFO}


# -- phase 7b: launch plans and the static-analysis layer on the card ---------
# the captured graphs of the run, by the function captured
GRAPH_CLASSES = {"slab": "slab_fn", "fit_step": "_fit_step",
                 "transpose": "apply_sqrt_T", "cg_segment": "_advance"}
# the guard band (elements) on each side of a witness output
GUARD = 4096
# the learned-θ paths whose matrix build phase 7b splits
THETA_SPLIT = ("regular", "dust_theta", "log_polar_theta")
SANITIZER_TIMEOUT = 600


def verify_static(sharded_plans) -> dict:
    """The verifier over every level of the four charts at full width (S =
    8, f32 and bf16: ``analysis.scenarios.chip_scenarios``), one process a
    scenario, and over the distinct plans phase 7's sharded runs launched
    through. -> the record and the findings."""
    import concurrent.futures as cf
    import functools
    import multiprocessing

    from repro_torch.analysis import kernel_verify as kv
    from repro_torch.analysis import scenarios as sc

    t0 = time.perf_counter()
    scns = sc.chip_scenarios(S)
    with cf.ProcessPoolExecutor(
            max_workers=len(scns),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        found = list(ex.map(functools.partial(kv.verify_scenario,
                                              transpose=False), scns))
    out = {"scenarios": {s.label: len(f) for s, f in zip(scns, found)},
           "static_s": time.perf_counter() - t0}
    findings = [f for fs in found for f in fs]
    distinct = {}
    for p in sharded_plans:
        distinct.setdefault(repr(p.describe()), p)
    for p in distinct.values():
        findings += kv.verify_plan(p, scenario="phase 7 sharded")
    out["sharded_plans"] = {"launches": len(sharded_plans),
                            "distinct": len(distinct)}
    return out, findings


def verify_transpose_card() -> tuple:
    """The transpose pass on the kernels, at the storage dtype (1e-5 at
    f32, 5e-2 with bf16 storage), over every launch unit of the four
    charts at full width, S = 2. -> (seconds, findings)."""
    import torch

    from repro_torch.analysis import kernel_verify as kv
    from repro_torch.analysis import scenarios as sc

    t0 = time.perf_counter()
    findings = []
    for scn in sc.chip_scenarios(S):
        dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[scn.storage]
        groups = kv.transpose_groups(kv.scenario_groups(scn, device="cuda"))
        findings += kv.verify_transpose(scn.chart(), groups, samples=2,
                                        dtype=dtype, device="cuda",
                                        scenario=scn.label)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, findings


def plan_ties() -> dict:
    """Every kernel node of every graph the run captured (``core.graphs.
    CAPTURES``) against the launch plan its wrapper launched through
    (``capture`` raises on a mismatch; this counts them), by kind: the
    slab, the fixed-θ fit step, the transpose and the CG segment must each
    have been captured and checked."""
    from repro_torch.core import graphs

    out = {}
    for rec in graphs.CAPTURES:
        kind = next((k for k, pat in GRAPH_CLASSES.items()
                     if pat in rec["fn"]), "other")
        o = out.setdefault(kind, {"graphs": 0, "nodes": 0, "equal": True})
        o["graphs"] += 1
        o["nodes"] += len(rec["nodes"])
        o["equal"] &= (collections.Counter(rec["nodes"])
                       == collections.Counter(rec["planned"]))
    missing = [k for k in GRAPH_CLASSES if not out.get(k, {}).get("nodes")]
    unequal = [k for k, o in out.items() if not o["equal"]]
    if missing or unequal:
        raise AssertionError(f"plan ties: no checked graph of {missing}, "
                             f"nodes unlike their plans in {unequal}")
    return out


def witness_cases(models, gen) -> dict:
    """Per kernel, one full-width case (f32): ``(launch(outs), outs' shapes,
    plain())``, ``launch`` the internal wrapper writing into the given
    output tensors, ``plain`` its plain version's outputs."""
    import torch

    from repro_torch.kernels import dispatch, icr_refine, nd_fused, pyramid

    f32 = torch.float32
    cases = {}

    def last_level(cname):
        icr, mats, _ = models[cname]
        lvl = icr.chart.n_levels - 1
        return icr, mats, lvl

    for cname, charted in (("regular", False), ("log", True)):
        icr, mats, lvl = last_level(cname)
        geom, field, xi, r, d, ax = level_inputs(icr, mats, lvl, f32, gen)
        _, (c, x, rr, dd) = dispatch.level_operands(field, xi, r, d, geom,
                                                    sample_axis=True)
        name = "refine_charted" if charted else "refine_stationary"
        cases[name] = (
            lambda outs, c=c, x=x, rr=rr, dd=dd, ch=charted:
            icr_refine._refine_1d(c, x, rr, dd, charted=ch, out=outs[0]),
            [(c.shape[0], x.shape[1] * x.shape[2])],
            lambda c=c, x=x, rr=rr, dd=dd, ch=charted: [
                (icr_refine.refine_charted_plain if ch else
                 icr_refine.refine_stationary_plain)(c, x, rr, dd)])
        (aname, g, r1, d1, length), = adjoint_cases(icr, mats, lvl, f32, gen)
        cases[aname] = (
            lambda outs, g=g, r1=r1, d1=d1, n=length, ch=charted:
            icr_refine._adjoint_1d(g, r1, d1, n, charted=ch, out=outs),
            [(g.shape[0], length), (g.shape[0], g.shape[1] // r1.shape[-2],
                                    r1.shape[-2])],
            lambda g=g, r1=r1, d1=d1, n=length, ch=charted: list(
                (icr_refine.refine_charted_adjoint_plain if ch else
                 icr_refine.refine_stationary_adjoint_plain)(
                    g, r1, d1, coarse_len=n)))
    for cname in ("dust", "log_polar"):
        icr, mats, lvl = last_level(cname)
        for name, coarse, r, t, _ in nn_cases(icr, mats, lvl, f32, gen):
            if name in cases:
                continue
            ch = r.ndim == 3
            cases[name] = (
                lambda outs, c=coarse, r=r, t=t, ch=ch:
                icr_refine._refine_1d(c, None, r, None, charted=ch, t=t,
                                      out=outs[0]),
                [(coarse.shape[0], t * r.shape[-2])],
                lambda c=coarse, r=r, t=t, ch=ch: [
                    icr_refine.refine_charted_nn_plain(c, r) if ch else
                    icr_refine.refine_stationary_nn_plain(c, r, t)])
        for name, g, r1, d1, length in adjoint_cases(icr, mats, lvl, f32,
                                                     gen)[1:]:
            if name in cases:
                continue
            ch = r1.ndim == 3
            cases[name] = (
                lambda outs, g=g, r1=r1, n=length, ch=ch:
                icr_refine._adjoint_1d(g, r1, None, n, charted=ch,
                                       out=(outs[0], None)),
                [(g.shape[0], length)],
                lambda g=g, r1=r1, n=length, ch=ch: [
                    (icr_refine.refine_charted_adjoint_plain if ch else
                     icr_refine.refine_stationary_adjoint_plain)(
                        g, r1, None, coarse_len=n)])
    icr, mats, lvl = last_level("dust")
    geom, field, xi, r, d, ax = level_inputs(icr, mats, lvl, f32, gen)
    args = nd_fused.nd_operands(field, xi, ax[0], ax[1], geom,
                                sample_axis=True)
    cases["refine_nd_fused"] = (
        lambda outs, a=args: nd_fused._nd_fused(*a, out=outs[0]),
        [tuple(args[1].shape)],
        lambda a=args: [nd_fused.refine_nd_fused_plain(*a)])
    icr, mats, _ = models["regular"]
    k = dispatch.pyramid_cover(icr.chart, samples=S)
    case = pyramid_case(icr, mats, f32, gen)
    geoms, pfield, levels = case[0][:k], case[1], case[2][:k]
    cases[PYRAMID] = (
        lambda outs, f=pfield, gs=geoms, lv=levels:
        pyramid._launch(f, gs, lv, out=outs[0]),
        [(S,) + tuple(geoms[-1].fine_shape)],
        lambda f=pfield, gs=geoms, lv=levels: [
            pyramid.refine_pyramid_plain(f, gs, lv)])
    return cases


def nan_witness(models, gen, problems) -> dict:
    """Each of the ten kernels and the eigensolver (at log's 65,536 4x4
    matrices) launched once at a full-width shape into
    outputs that sit inside NaN-filled buffers with a guard band of
    ``GUARD`` elements on each side: no NaN may remain inside, the guard
    bands must stay NaN, and the result must equal the plain version (at
    the f32 tolerance). No kernel of the port adds into its output."""
    import torch

    from repro_torch.kernels import sym_eig

    cases = witness_cases(models, gen)
    a = next(v for k, v in eig_cases(problems).items() if k.startswith("log-"))
    cases[EIG] = (lambda outs, a=a: sym_eig.sym_eig(a, out=outs),
                  [tuple(a.shape[:-1]), tuple(a.shape), (a.shape[0],)],
                  lambda a=a: list(sym_eig.sym_eig_plain(a)))
    out = {}
    for name, (launch_into, shapes, plain) in cases.items():
        bufs = [torch.full((math.prod(s) + 2 * GUARD,), float("nan"),
                           device="cuda") for s in shapes]
        outs = [b[GUARD:GUARD + math.prod(s)].view(s)
                for b, s in zip(bufs, shapes)]
        launch_into(outs)
        torch.cuda.synchronize()
        want = plain()
        inside_nan = sum(int(torch.isnan(o).sum()) for o in outs)
        guards_kept = all(bool(torch.isnan(b[:GUARD]).all()
                               and torch.isnan(b[-GUARD:]).all())
                          for b in bufs)
        err = max(rel_err(o, w)[1] for o, w in zip(outs, want))
        out[name] = {"nan_inside": inside_nan, "guards_nan": guards_kept,
                     "max_rel_err": err,
                     "elements": sum(math.prod(s) for s in shapes)}
        if inside_nan or not guards_kept or not err <= TOL["float32"]:
            raise AssertionError(f"witness {name}: {out[name]}")
    if set(out) != set(COUNTED):
        raise AssertionError(f"witness: no case of "
                             f"{sorted(set(COUNTED) - set(out))}")
    return out


def kernels_once() -> int:
    """``--kernels-once``: every kernel of the port launched at least once
    at a small shape (the transpose pass on the card over a 1-D stationary
    chart with its pyramid, a charted 1-D chart and an N-D chart, f32):
    the program the sanitizers run. Exits 1 on a transpose finding."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis import kernel_verify as kv
    from repro_torch.core import charts as tc
    from repro_torch.kernels import build, dispatch, sym_eig

    build.LAUNCHES.clear()
    findings = []
    for chart in (tc.regular_chart(64, 3, boundary="reflect"),
                  tc.log_chart(64, 3, n_csz=5, n_fsz=4, delta0=0.01),
                  tc.galactic_dust_chart((6, 8, 8), n_levels=2)):
        groups = dispatch.chart_launch_plans(chart, samples=2)
        groups += [g for g in dispatch.chart_launch_plans(
            chart, samples=2, pyramid=False) if g["route"] != "pyramid"]
        findings += kv.verify_transpose(chart, groups, samples=2,
                                        dtype=torch.float32, device="cuda")
    for n in (4, 8):   # the eigensolver's thread and warp routes
        a = torch.randn((9, n, n), device="cuda")
        sym_eig.sym_eig(a + a.mT)
    torch.cuda.synchronize()
    print(json.dumps({"launches": dict(build.LAUNCHES),
                      "findings": [str(f) for f in findings]}))
    silent = [k for k in COUNTED if not build.LAUNCHES[k]]
    return 1 if findings or silent else 0


def sanitize() -> dict:
    """``compute-sanitizer --tool memcheck`` and ``--tool racecheck`` over
    ``--kernels-once``, on the port's kernels only (``--kernel-name
    kns=refine_``), both at once. Where the toolkit has no
    ``compute-sanitizer``, or the tool refuses the card ("Device not
    supported"), that is recorded in the line and the run goes on. Any
    other end fails the run: an error or hazard reported, a non-zero exit
    code, a timeout, or no summary printed."""
    import re
    import shutil

    tool = shutil.which("compute-sanitizer")
    default = Path("/usr/local/cuda/bin/compute-sanitizer")
    if tool is None and default.exists():
        tool = str(default)
    if tool is None:
        return {"available": False}
    procs = {t: subprocess.Popen(
        [tool, "--tool", t, "--kernel-name", "kns=refine_", sys.executable,
         str(Path(__file__).resolve()), "--kernels-once"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for t in ("memcheck", "racecheck")}
    out = {"available": True, "tool": tool}
    failed = []
    for t, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=SANITIZER_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            out[t] = {"ran": False, "why": "timed out",
                      "tail": log[-1500:]}
            failed.append(t)
            continue
        summary = re.search(r"(ERROR|RACECHECK) SUMMARY: (\d+)", log)
        unsupported = re.search(r"Error: (Device not supported[^\n]*)", log)
        rec = {"ran": summary is not None and unsupported is None,
               "returncode": proc.returncode}
        if unsupported is not None:
            # the tool starts, then refuses the card: the process's CUDA
            # calls fail under it, which it counts as errors of its own
            rec["why"] = unsupported.group(1)
            rec["head"] = log[:300]
        elif summary is None:
            rec["why"] = "no summary"
            rec["tail"] = log[-1500:]
            failed.append(t)
        else:
            rec["reported"] = int(summary.group(2))
            rec["summary"] = log[summary.start():].splitlines()[0]
            if rec["reported"] or proc.returncode:
                failed.append(t)
                rec["tail"] = log[-1500:]
        out[t] = rec
    if failed:
        raise AssertionError(f"sanitizer {failed}: {out}")
    return out


def roofline_lines(models, gen) -> dict:
    """The profiler roofline (``roofline.analysis``) of the apply (S = 8),
    the VJP (the transpose op by op) and the served slab (one graph
    replay) on the four charts, f32: each port kernel's device ms per
    call, its plans' bound at the H100's 3.35 TB/s and the share of it,
    and the other device work's largest ops."""
    import torch

    from repro_torch.kernels import launch
    from repro_torch.launch.serve_gp import GPFieldServer, demo_posterior
    from repro_torch.roofline import analysis

    out = {}
    rho = {c: k.default_theta["rho"] for c, (_, k) in charts().items()}
    for cname, (icr, mats, _) in models.items():
        gen.manual_seed(61)
        xi = icr.init_xi(gen, batch=S)
        v = torch.randn((S,) + icr.out_shape, generator=gen, device="cuda")
        srv = GPFieldServer(demo_posterior(icr.chart, rho[cname]), slab=S)
        slab = srv._entry["fn"]
        entries = {
            "apply": lambda: icr.apply_sqrt_batch(mats, xi),
            "vjp": lambda: icr.apply_sqrt_T_batch(mats, v, cached=False),
        }
        row = {}
        for ename, fn in entries.items():
            with launch.recording() as plans:
                fn()
            events = analysis.profile(fn, calls=3)
            row[ename] = analysis.roofline(analysis.attribute(events), plans,
                                           calls=3)
        events = analysis.profile(slab, calls=3)
        row["slab"] = analysis.roofline(analysis.attribute(events),
                                        slab.plans, calls=3)
        out[cname] = row
        del srv
    return out


def theta_split(problems) -> dict:
    """One learned-θ step's matrix build split apart (f32, CUDA events,
    median of 5): the level-0 root (``level0_sqrt``), the per-level builds
    (joint on 1-D charts, the per-axis factors on N-D ones, as
    ``ICR.matrices`` builds them on the kernel route) and the backward of
    each to ρ's latent, on regular, dust_theta and log_polar_theta; each
    op by op and (``graph_*``) as one replay of its captured CUDA graph,
    as a compiled step runs it. Call inside ``build_checks()``."""
    import torch

    from repro_torch.core import graphs
    from repro_torch.core.refine import (axis_refinement_matrices_level,
                                         level0_sqrt,
                                         refinement_matrices_level)

    def med(fn):
        ts = []
        for _ in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts[1:])

    out = {}
    for pname in THETA_SPLIT:
        p = problems[pname]
        icr, priors = p["icr"], p["priors"]
        latent = {n: t.detach().clone().requires_grad_(True)
                  for n, t in priors.zero_xi().items()}
        chart = icr.chart
        kw = dict(jitter=icr.jitter, device=icr.device, dtype=torch.float32)
        build_level = (axis_refinement_matrices_level if chart.ndim > 1
                       else refinement_matrices_level)

        def kernel():
            theta = dict(priors(latent))
            theta["sigma"] = 1.0
            return icr.kernel(theta)

        def root():
            return level0_sqrt(chart, kernel(), **kw)

        def levels():
            k = kernel()
            return [build_level(chart, k, lvl, **kw)
                    for lvl in range(chart.n_levels)]

        def backward(build):
            def run():
                leaves = [t for t in _flat(build()) if t.requires_grad]
                loss = sum((t * t).sum() for t in leaves)
                torch.autograd.grad(loss, list(latent.values()))
            return run

        entry = {"level0_points": math.prod(chart.shape(0)),
                 "levels": chart.n_levels}
        for tag, wrap in (("", lambda fn: fn),
                          ("graph_", lambda fn: graphs.capture(
                              fn, device="cuda"))):
            root_ms, levels_ms = med(wrap(root)), med(wrap(levels))
            entry.update({
                f"{tag}root_ms": root_ms, f"{tag}levels_ms": levels_ms,
                f"{tag}root_backward_ms": med(wrap(backward(root)))
                - root_ms,
                f"{tag}levels_backward_ms": med(wrap(backward(levels)))
                - levels_ms})
        out[pname] = entry
    return out


def _flat(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat(x)]
    return [tree]


def check_analysis(models, problems, gen, sharded_plans) -> float:
    """Phase 7b: the launch plans and the static-analysis layer on the
    card (see the module docstring), one line per part. The sanitizers
    run beside the static verifier (CPU work) and end before anything is
    timed on the card. Returns the phase's seconds."""
    import threading

    import torch

    from repro_torch.analysis import lint
    from repro_torch.analysis import scenarios as sc
    from repro_torch.kernels import pyramid

    t_phase = time.perf_counter()
    box = []

    def run_sanitizer():
        try:
            box.append(sanitize())
        except Exception as exc:   # raised below, in the main thread
            box.append(exc)

    worker = threading.Thread(target=run_sanitizer)
    worker.start()
    try:
        verify, findings = verify_static(sharded_plans)
    finally:
        worker.join()
    if isinstance(box[0], Exception):
        raise box[0]
    print("sanitizer: " + json.dumps(box[0]), flush=True)
    verify["transpose_s"], more = verify_transpose_card()
    findings += more
    verify["findings"] = [str(f) for f in findings]
    print("verify: " + json.dumps(verify), flush=True)
    if findings:
        raise AssertionError("verify: " + "; ".join(verify["findings"][:10]))

    ties = plan_ties()
    ties["pyramid_resident"] = {
        "card_1d": pyramid.resident_blocks(torch.float32, False, 2, 3, 0,
                                           "cuda"),
        "model_1d": pyramid.resident_blocks(torch.float32, False, 2, 3, 0)}
    print("plan_ties: " + json.dumps(ties), flush=True)
    print("witness: " + json.dumps(nan_witness(models, gen, problems)),
          flush=True)
    regs = lint.ptxas_lines()
    lint_found = [f for scn in sc.chip_scenarios(S)
                  for f in lint.lint_scenario(scn, registers=regs)]
    print("lint: " + json.dumps([str(f) for f in lint_found]), flush=True)
    if lint_found:
        raise AssertionError(f"lint: {lint_found[:5]}")
    print("roofline: " + json.dumps(roofline_lines(models, gen)), flush=True)
    from repro_torch.core.refine import build_checks

    with build_checks():
        split = theta_split(problems)
    print("theta_split: " + json.dumps(split), flush=True)
    return time.perf_counter() - t_phase


# -- phase 9: LM serving (models/, launch/serve.py) ---------------------------
# the full-width model phase 9 serves, its server and its traffic
LM_ARCH = "gemma3-4b"
LM_SLOTS, LM_S_MAX, LM_REQUESTS, LM_MAX_NEW = 4, 2048, 8, 32
LM_PROMPTS = (16, 1200)      # prompt lengths drawn in this range
LM_SEED = 1                  # its 8 lengths: 1,142 and 1,140 pass the window
LM_WINDOW = 1024             # gemma3-4b's sliding window
LM_DECODE_LEN = 1100         # decode against prefill, past the window
LM_TF_TOL = 5e-2             # normalized logits (tests/test_decode_consistency)
LM_GAP_ROWS = (1, 16, 128)   # decode against the prefill of these prefixes too
LM_CARD_TOL = 1e-4           # reduced archs: card against CPU, of max |logit|
LM_STEPS = 16                # reduced archs: decode steps


def lm_tf_agreement(got, full) -> dict:
    """Decode's last logits against teacher forcing, as the JAX package's
    decode-consistency test holds them: argmax equal, and the normalized
    logits within ``assert_allclose(rtol=5e-2, atol=5e-2)``."""
    def norm(x):
        x = x.double()
        return (x - x.mean(-1, keepdim=True)) / (x.std(-1, keepdim=True)
                                                 + 1e-6)

    g, f = norm(got), norm(full)
    diff = (g - f).abs()
    argmax = bool((got.argmax(-1) == full.argmax(-1)).all())
    return {"argmax_equal": argmax, "max_norm_diff": diff.max().item(),
            "ok": argmax and bool((diff <= LM_TF_TOL
                                   + LM_TF_TOL * f.abs()).all())}


def lm_step_bits(srv, tokens, positions) -> tuple:
    """One captured step against ``Model.serve_step`` op by op from the
    same cache. Returns (logits and every cache leaf equal bit for bit,
    the eager step's logits); the cache is left as the eager step wrote
    it."""
    import torch

    from repro_torch.models.tree import tree_map, tree_store

    before = tree_map(torch.clone, srv.cache)
    graph_logits = srv.decode(tokens, positions).clone()
    graph_cache = tree_map(torch.clone, srv.cache)
    tree_store(srv.cache, before)
    del before
    eager_logits = srv.model.serve_step(srv.params, srv.cache, tokens,
                                        positions)
    return (torch.equal(graph_logits, eager_logits)
            and same_bits(graph_cache, srv.cache)), eager_logits


def lm_reduced_case(name) -> dict:
    """A reduced architecture at float32: ``prefill_fn`` and 16 captured
    steps on the card against the same model and parameters on the CPU
    (<= 1e-4 of the largest |logit|), the middle step graph = eager bit
    for bit, and decode against teacher forcing on the card."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import build_model
    from repro_torch.models.tree import tree_map

    cfg = get_arch(name).reduced()
    model = build_model(cfg)
    b = 2
    params = model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, LM_STEPS), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks}
    if cfg.encoder is not None:
        batch["enc_embeds"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.d_model), generator=gen)
    full_cpu = model.prefill_fn(params, batch)
    srv = BatchedServer(cfg, batch_slots=b, s_max=LM_STEPS,
                        params=tree_map(lambda t: t.cuda(), params))
    card_batch = tree_map(lambda t: t.cuda(), batch)
    full = model.prefill_fn(srv.params, card_batch)
    cache = model.init_cache(b, LM_STEPS, device="cpu")
    if cfg.encoder is not None:
        model.prepare_cross_cache(params, cache, batch["enc_embeds"])
        model.prepare_cross_cache(srv.params, srv.cache,
                                  card_batch["enc_embeds"])
    step_err, bits = 0.0, None
    for i in range(LM_STEPS):
        pos = torch.full((b,), i, dtype=torch.int32)
        want = model.serve_step(params, cache, toks[:, i:i + 1], pos)
        tok_d, pos_d = toks[:, i:i + 1].cuda(), pos.cuda()
        if i == LM_STEPS // 2:
            bits, got = lm_step_bits(srv, tok_d, pos_d)
        else:
            got = srv.decode(tok_d, pos_d)
        step_err = max(step_err, rel_err(got.cpu(), want)[1])
    return {"prefill_rel_err": rel_err(full.cpu(), full_cpu)[1],
            "step_rel_err": step_err, "graph_equals_eager": bits,
            "teacher_forcing": lm_tf_agreement(got.cpu(), full.cpu())}


def lm_decode_vs_prefill(cfg, params, tokens) -> dict:
    """`tokens` (1, n) decoded one by one through a captured step (one
    slot) against ``prefill_fn`` at the last position; ``by_rows``: the
    normalized gap after each of ``LM_GAP_ROWS`` tokens against the
    prefill of that prefix (a prefill GEMM of that many rows)."""
    import torch

    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import build_model

    n = tokens.shape[1]
    model = build_model(cfg)
    full = model.prefill_fn(params, {"tokens": tokens})
    srv = BatchedServer(cfg, batch_slots=1, s_max=LM_S_MAX, params=params)
    positions = torch.arange(n, dtype=torch.int32, device="cuda")
    by_rows = {}
    for i in range(n):
        got = srv.decode(tokens[:, i:i + 1], positions[i:i + 1])
        if i + 1 in LM_GAP_ROWS:
            by_rows[i + 1] = lm_tf_agreement(got, model.prefill_fn(
                params, {"tokens": tokens[:, :i + 1]}))["max_norm_diff"]
    out = lm_tf_agreement(got, full)
    out["by_rows"] = by_rows
    del srv, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_serve_requests(srv, vocab) -> dict:
    """LM_REQUESTS seeded requests through `srv`'s slots: every one done,
    every token in the vocab, the prefill/decode accounting; the ring
    buffers wrap on the prompts past the window."""
    import numpy as np

    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1, LM_REQUESTS)
    if lens.max() <= LM_WINDOW:
        raise RuntimeError(f"no prompt past the window: {lens.tolist()}")
    reqs = [Request(prompt=rng.integers(0, vocab, int(n)), max_new=LM_MAX_NEW)
            for n in lens]
    steps0 = srv.prefill_tokens + srv.decode_tokens
    t0 = time.perf_counter()
    srv.run(reqs)
    wall = time.perf_counter() - t0
    want_prefill = int(sum(n - 1 for n in lens))
    ok = (all(r.done and r.error is None and len(r.out) == LM_MAX_NEW
              for r in reqs)
          and all(0 <= t < vocab for r in reqs for t in r.out)
          and srv.prefill_tokens == want_prefill
          and srv.decode_tokens == LM_REQUESTS * LM_MAX_NEW)
    if not ok:
        raise RuntimeError(
            f"serving failed: prefill {srv.prefill_tokens} (want "
            f"{want_prefill}), decode {srv.decode_tokens}, "
            f"{[(r.done, r.error, len(r.out)) for r in reqs]}")
    return {"requests": LM_REQUESTS, "prompt_lens": lens.tolist(),
            "prefill_tokens": srv.prefill_tokens,
            "decode_tokens": srv.decode_tokens,
            "token_steps": srv.prefill_tokens + srv.decode_tokens - steps0,
            "wall_s": wall}


def lm_step_profile(fn, calls: int = 5) -> dict:
    """The kernels of `calls` calls of `fn` under ``torch.profiler``: per
    call their count and summed device ms, and the eight names that take
    the most device time."""
    from repro_torch.roofline.analysis import profile

    kernels = [e for e in profile(fn, calls=calls)
               if e.get("cat") == "kernel"]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"kernels_per_call": len(kernels) / calls,
            "kernel_ms": sum(e["dur"] for e in kernels) / calls / 1e3,
            "top": [{"name": n[:100], "per_call": c / calls,
                     "ms": d / calls / 1e3} for n, (c, d) in top]}


def check_lm(card) -> dict:
    """Phase 9: the ten reduced architectures on the card against the
    CPU, then gemma3-4b at full width and depth in bfloat16 served
    through ``BatchedServer`` (4 slots, s_max 2048). Returns the
    ``lm_serve`` record; a failed check raises."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.tree import tree_leaves, tree_map

    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t_phase = time.perf_counter()
    reduced = {name: lm_reduced_case(name) for name in sorted(ARCHS)}
    record["reduced"] = reduced
    bad = [n for n, r in reduced.items()
           if not (r["prefill_rel_err"] <= LM_CARD_TOL
                   and r["step_rel_err"] <= LM_CARD_TOL
                   and r["graph_equals_eager"]
                   and r["teacher_forcing"]["ok"])]
    print("lm_reduced: " + json.dumps(reduced), flush=True)
    if bad:
        raise RuntimeError(f"reduced architectures failed on the card: {bad}")
    record["reduced_s"] = time.perf_counter() - t_phase

    # -- gemma3-4b at full width and depth, bfloat16 --------------------------
    cfg = get_arch(LM_ARCH)
    t0 = time.perf_counter()
    srv = BatchedServer(cfg, batch_slots=LM_SLOTS, s_max=LM_S_MAX, seed=0)
    torch.cuda.synchronize()
    record["build_s"] = time.perf_counter() - t0
    leaves = tree_leaves(srv.params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(srv.cache))
    if n_params != srv.model.param_count():
        raise RuntimeError("param_count differs from the drawn tree")
    # the step reads every weight and, at most, every cache row once
    from repro_torch.launch.mesh import bandwidth_of

    bandwidth = bandwidth_of(torch.cuda.get_device_name(0))
    record.update(param_count=n_params, param_bytes=param_bytes,
                  cache_bytes=cache_bytes, bandwidth=bandwidth,
                  weight_bound_ms=param_bytes / bandwidth * 1e3,
                  cache_bound_ms=cache_bytes / bandwidth * 1e3)

    # one step with every slot live, at staggered positions
    gen = torch.Generator(device="cuda").manual_seed(3)
    for i in range(4):
        srv.decode(torch.randint(0, cfg.vocab_size, (LM_SLOTS, 1),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32),
                   torch.full((LM_SLOTS,), i, dtype=torch.int32,
                              device="cuda"))
    tok = torch.randint(0, cfg.vocab_size, (LM_SLOTS, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    pos = torch.tensor([4, 4, 2, 4], dtype=torch.int32, device="cuda")
    bits, _ = lm_step_bits(srv, tok, pos)
    record["graph_equals_eager"] = bits
    if not bits:
        raise RuntimeError(f"{LM_ARCH}: the captured step differs from "
                           "serve_step op by op")

    # times: the step replayed and op by op (the same write each time)
    flush = torch.empty(256 * 2**20, dtype=torch.float32, device="cuda")

    def graph_step():
        return srv.decode(tok, pos)

    def eager_step():
        return srv.model.serve_step(srv.params, srv.cache, tok, pos)

    def copy_in():
        srv._tokens.copy_(tok)
        srv._positions.copy_(pos)

    record["step_graph_ms"] = time_ms(graph_step, flush)
    record["step_eager_ms"] = time_ms(eager_step, flush)
    # host ms: one call on an idle card (median, min and max of 25), and
    # per call of back-to-back blocks (median of 5); the graph step split
    # into its copy-in and its replay
    record["enqueue"] = {
        key: {"idle": enqueue_spread(fn),
              "back_to_back": host_ms_per_call(fn, calls=20, blocks=5)}
        for key, fn in (("graph", graph_step), ("eager", eager_step),
                        ("copy_in", copy_in),
                        ("replay", srv._step.graph.replay))}
    record["enqueue_graph_ms"] = record["enqueue"]["graph"]["idle"]["median"]
    record["enqueue_eager_ms"] = record["enqueue"]["eager"]["idle"]["median"]
    logits = graph_step()
    torch.cuda.synchronize()
    d2h = []
    for _ in range(REPS):
        t1 = time.perf_counter()
        logits.cpu()
        d2h.append((time.perf_counter() - t1) * 1e3)
    record["logits_d2h_ms"] = statistics.median(d2h)
    record["step_profile"] = lm_step_profile(graph_step)
    record["decode_tok_s"] = LM_SLOTS / (host_ms_per_call(
        lambda: graph_step().cpu(), calls=50, blocks=3) / 1e3)
    prompt = torch.randint(0, cfg.vocab_size, (1, LM_DECODE_LEN),
                           generator=gen, device="cuda", dtype=torch.int32)
    record["prefill_1100_ms"] = time_ms(
        lambda: srv.model.prefill_fn(srv.params, {"tokens": prompt}), flush)
    del flush

    # serving: 8 requests through the 4 slots
    record["serve"] = lm_serve_requests(srv, cfg.vocab_size)
    print(f"lm: served at {time.perf_counter() - t_phase:.1f} s", flush=True)

    # decode against prefill over 1,100 tokens: bf16, then (where bf16
    # misses) the same weights widened to float32
    params = srv.params
    del srv, logits
    gc.collect()
    torch.cuda.empty_cache()
    tf = {"bfloat16": lm_decode_vs_prefill(cfg, params, prompt)}
    if not tf["bfloat16"]["ok"]:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    act_dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        tf["float32"] = lm_decode_vs_prefill(cfg32, params32, prompt)
        if not tf["float32"]["ok"]:
            raise RuntimeError(f"{LM_ARCH}: decode differs from prefill at "
                               f"float32: {tf}")
    record["decode_vs_prefill"] = tf
    record["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["phase_s"] = time.perf_counter() - t_phase
    return record


# -- phase 10: LM training (the models' backward, optim/, launch/steps.py,
# launch/train.py) --------------------------------------------------------------
LMT_SEQ, LMT_BATCH, LMT_STEPS = 4096, 2, 8   # train_4k's length, batch 2
LMT_REDUCED = (4, 32)        # reduced archs: batch, tokens (whisper's 32)
LMT_CARD_TOL = 1e-4          # reduced: card against CPU, per leaf
LMT_REMAT_TOL = 1e-6         # reduced: remat on against off, on the card
LMT_OPT_TOL = 1e-6           # one optimizer step, card against CPU
LMT_COS_MIN = 0.99           # gemma3-4b: bf16 gradients against float32
LMT_LR = 1e-3                # the optimizers' step in 10a


def lmt_grads(model, params, batch) -> tuple:
    """(loss, gradient leaves) of ``model.loss_fn``; a leaf the loss does
    not reach gets zeros, as ``jax.grad`` gives it."""
    import torch

    from repro_torch.models.tree import tree_leaves

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), [g.detach() for g in grads]


def lmt_leaf_errs(got, want) -> tuple:
    """(max over leaves of max|got - want| / max|want|, max level of the
    leaves whose reference is zero in exact arithmetic). A leaf whose
    reference is below 1e-6 of the largest entry of all leaves (whisper's
    key biases: the softmax cancels them) is held by its level, both
    sides, relative to that largest entry."""
    top = max(float(w.abs().max()) for w in want)
    worst, zero = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        scale = float(w.abs().max())
        if scale <= 1e-6 * top:
            zero = max(zero, float(g.abs().max()) / top, scale / top)
        else:
            worst = max(worst, float((g - w).abs().max()) / scale)
    return worst, zero


class RouteRecorder:
    """Wraps ``moe._dispatch_chunk`` and records each call's top-k experts
    and its routing margin (the k-th largest router probability minus the
    (k+1)-th)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.inner = moe, moe._dispatch_chunk
        self.routes, self.margins = [], []

    def __call__(self, params, x, moe_cfg, capacity):
        import torch

        from repro_torch.models.layers import matmul

        with torch.no_grad():
            probs = torch.softmax(matmul(x, params["router"]).float(), -1)
            top = torch.topk(probs, moe_cfg.top_k + 1, dim=-1)
            self.routes.append(top.indices[..., :-1].cpu())
            self.margins.append(float((top.values[..., -2]
                                       - top.values[..., -1]).min()))
        return self.inner(params, x, moe_cfg, capacity)

    def __enter__(self):
        self.moe._dispatch_chunk = self
        return self

    def __exit__(self, *exc):
        self.moe._dispatch_chunk = self.inner


def lmt_reduced_batch(cfg, device) -> dict:
    """A seeded ``SyntheticLMData`` batch (and the frontends' inputs)."""
    import torch

    from repro_torch.data import SyntheticLMData

    b, s = LMT_REDUCED
    host = SyntheticLMData(cfg.vocab_size, s, b, seed=3).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    gen = torch.Generator().manual_seed(4)
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    if cfg.encoder is not None:
        batch["enc_embeds"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.d_model), generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def lmt_reduced_case(name, device="cuda") -> dict:
    """Phase 10a on one reduced architecture at float32: loss and every
    gradient leaf on `device` against the CPU; remat on against off on
    `device`; one step of sgd (momentum 0.9), adamw and adafactor from the
    CPU's gradients on both; an ``accum = 2`` SGD train step on both; on
    the MoE architectures, first, the top-k routes on both."""
    import dataclasses
    import unittest.mock

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.optim import constant, optimizers

    cfg = get_arch(name).reduced()
    model = build_model(cfg)
    p_cpu = model.init_params(torch.Generator().manual_seed(0))
    p_dev = tree_map(lambda t: t.detach().to(device), p_cpu)
    b_cpu, b_dev = lmt_reduced_batch(cfg, "cpu"), lmt_reduced_batch(
        cfg, device)
    rec = {}
    if cfg.moe:
        with RouteRecorder() as r_cpu:
            model.loss_fn(p_cpu, b_cpu)
        with RouteRecorder() as r_dev:
            model.loss_fn(p_dev, b_dev)
        rec["routes_agree"] = all(
            torch.equal(a, b) for a, b in zip(r_cpu.routes, r_dev.routes))
        rec["min_route_margin"] = min(r_cpu.margins)
        if not rec["routes_agree"]:
            raise RuntimeError(f"{name}: top-k routes differ between the "
                               f"CPU and the card: {rec}")
    l_cpu, g_cpu = lmt_grads(model, p_cpu, b_cpu)
    l_dev, g_dev = lmt_grads(model, p_dev, b_dev)
    rec["loss"] = float(l_cpu)
    rec["loss_rel_err"] = abs(float(l_dev) - float(l_cpu)) / max(
        abs(float(l_cpu)), 1e-30)
    rec["grad_rel_err"], rec["grad_zero_level"] = lmt_leaf_errs(g_dev,
                                                                g_cpu)
    remat = build_model(dataclasses.replace(cfg, remat=True))
    l_rm, g_rm = lmt_grads(remat, p_dev, b_dev)
    rec["remat_loss_equal"] = bool(torch.equal(l_rm, l_dev))
    rec["remat_rel_err"], rec["remat_zero_level"] = lmt_leaf_errs(g_rm,
                                                                  g_dev)

    # one optimizer step on both, from the CPU's gradients
    g_tree = [g.clone() for g in g_cpu]
    opts = {"sgd": lambda: optimizers.sgd(constant(LMT_LR), 0.9),
            "adamw": lambda: optimizers.adamw(constant(LMT_LR),
                                              weight_decay=0.1),
            "adafactor": lambda: optimizers.adafactor(constant(LMT_LR))}
    rec["opt_rel_err"] = {}
    for oname, make in opts.items():
        outs = []
        for dev in ("cpu", device):
            params = [t.detach().to(dev).clone() for t in tree_leaves(p_cpu)]
            opt = make()
            state = opt.init(params)
            new, state = opt.update([g.to(dev) for g in g_tree], state,
                                    params)
            outs.append(tree_leaves(new) + tree_leaves(state.inner))
        rec["opt_rel_err"][oname] = lmt_leaf_errs(outs[1], outs[0])[0]

    # an accum = 2 step of SGD at a fixed rate on both
    sgd = (optimizers.sgd(constant(LMT_LR * 100)), "sgd")
    with unittest.mock.patch.object(steps, "select_optimizer",
                                    lambda model, total_steps=0: sgd):
        outs = []
        for dev, batch in (("cpu", b_cpu), (device, b_dev)):
            ts = steps.make_train_step(
                cfg, make_host_mesh(devices=[dev]), accum=2)
            params = tree_map(lambda t: t.detach().to(dev).clone(), p_cpu)
            new, _, metrics = ts.fn(params, ts.optimizer.init(params),
                                    batch)
            outs.append((float(metrics["loss"]), tree_leaves(new)))
    rec["accum2_loss_rel_err"] = abs(outs[1][0] - outs[0][0]) / abs(
        outs[0][0])
    rec["accum2_param_rel_err"] = lmt_leaf_errs(outs[1][1], outs[0][1])[0]
    rec["ok"] = (rec["loss_rel_err"] <= LMT_CARD_TOL
                 and rec["grad_rel_err"] <= LMT_CARD_TOL
                 and rec["grad_zero_level"] <= 1e-6
                 and rec["remat_rel_err"] <= LMT_REMAT_TOL
                 and rec["remat_zero_level"] <= 1e-6
                 and max(rec["opt_rel_err"].values()) <= LMT_OPT_TOL
                 and rec["accum2_loss_rel_err"] <= LMT_CARD_TOL
                 and rec["accum2_param_rel_err"] <= LMT_CARD_TOL)
    return rec


def lmt_subset(params) -> dict:
    """The gradient check's named leaves: the tied table, the first
    group's rows of the stacked leaves, the last tail layer, the final
    norm (name -> (leaf, row or None))."""
    def named(tree, prefix):
        if isinstance(tree, dict):
            return {n: v for k in sorted(tree)
                    for n, v in named(tree[k], f"{prefix}.{k}").items()}
        return {prefix: tree}

    out = {"embed.table": (params["embed"]["table"], None),
           "final_norm.scale": (params["final_norm"]["scale"], None)}
    out.update({n: (t, 0) for n, t in named(params["groups"],
                                            "groups").items()})
    out.update({n: (t, None) for n, t in named(params["tail"][-1],
                                               "tail[-1]").items()})
    return out


def lmt_subset_grads(model, params, batch) -> dict:
    """Gradients of the named subset only (every other leaf frozen), as
    float32, each stacked leaf's first row."""
    import torch

    from repro_torch.models.tree import tree_leaves

    for t in tree_leaves(params):
        t.requires_grad_(False)
    subset = lmt_subset(params)
    leaves = [t for t, _ in subset.values()]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    out = {n: (g if row is None else g[row]).float()
           for (n, (_, row)), g in zip(subset.items(), grads)}
    for t in leaves:
        t.requires_grad_(False)
    return float(loss.detach()), out


def lmt_backward_cost(model, params, batch, sync) -> dict:
    """Peak memory and time of one forward and backward of every leaf."""
    import torch

    if sync:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _, grads = lmt_grads(model, params, batch)
    out = {"s": None, "peak_gb": None}
    if sync:
        torch.cuda.synchronize()
        out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    out["s"] = time.perf_counter() - t0
    del grads
    return out


def lmt_sync_points(step) -> dict:
    """The operations of one call of `step` that wait for the card, as
    CUDA's sync debug mode reports them: their count and the distinct
    messages and call sites."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return {"count": len(syncs),
            "sites": sorted({f"{w.filename}:{w.lineno}" for w in syncs}),
            "messages": sorted({str(w.message).splitlines()[0][:160]
                                for w in syncs})}


def lmt_full(cfg, seq, batch_rows, device="cuda", steps_n=LMT_STEPS) -> dict:
    """Phase 10b: `cfg` at full width with remat: the stacked leaves'
    gradient through ``x[g]`` (the code) against ``unbind``, the bf16
    gradient check against float32 on the named subset, ``train_loop``
    for `steps_n` steps, step 0's batch re-evaluated, one step profiled
    and its host syncs listed."""
    import dataclasses
    import unittest.mock

    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, make_host_mesh
    from repro_torch.launch.steps import active_param_count, make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model, transformer
    from repro_torch.models.tree import tree_map
    from repro_torch.roofline.analysis import model_flops_train

    cuda = torch.device(device).type == "cuda"
    cfg = dataclasses.replace(cfg, remat=True)
    model = build_model(cfg)
    rec = {"arch": cfg.name, "seq_len": seq, "global_batch": batch_rows,
           "steps": steps_n, "remat": True}
    data = SyntheticLMData(cfg.vocab_size, seq, batch_rows, seed=0)
    batch0 = {k: torch.from_numpy(v).to(device)
              for k, v in data.batch(0).items()}
    params = model.init_params(torch.Generator(device=device).manual_seed(0))

    # the stacked leaves' gradient: rows by x[g] (the code) against unbind
    def unbind_rows(groups, n):
        rows = [{} for _ in range(n)]

        def split(tree, outs):
            for k, v in tree.items():
                if isinstance(v, dict):
                    split(v, [o.setdefault(k, {}) for o in outs])
                else:
                    for o, r in zip(outs, v.unbind(0)):
                        o[k] = r

        split(groups, rows)
        return rows

    variants = {"select": transformer.group_rows, "unbind": unbind_rows}
    lmt_backward_cost(model, params, batch0, cuda)      # warm-up
    rec["stacked_grad"] = {k: [] for k in variants}
    for name in ("select", "unbind", "unbind", "select"):
        with unittest.mock.patch.object(transformer, "group_rows",
                                        variants[name]):
            rec["stacked_grad"][name].append(
                lmt_backward_cost(model, params, batch0, cuda))

    # bf16 gradients of the subset against a float32 copy of the weights
    loss16, g16 = lmt_subset_grads(model, params, batch0)
    params32 = tree_map(lambda t: t.float(), params)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    loss32, g32 = lmt_subset_grads(build_model(cfg32), params32, batch0)
    del params32
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    a = torch.cat([g.flatten().double() for g in g16.values()])
    b = torch.cat([g.flatten().double() for g in g32.values()])
    rec["grad_check"] = {
        "cosine": float(a @ b / (a.norm() * b.norm())),
        "loss_bf16": loss16, "loss_f32": loss32,
        "leaves": len(g16),
        "rel_err": {n: float((g16[n].double() - g32[n].double()).norm()
                             / g32[n].double().norm().clamp_min(1e-30))
                    for n in g16}}
    del a, b, g16, g32
    gc.collect()

    # the training: train_loop, AdamW from select_optimizer
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_loop(cfg, steps=steps_n, global_batch=batch_rows,
                     seq_len=seq, seed=0, log_every=1, device=device)
    rec["loop_s"] = time.perf_counter() - t0
    if cuda:
        rec["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["max_memory_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    params, opt_state = res.state
    rec["losses"] = res.losses
    rec["step_ms_all"] = res.step_ms
    rec["enqueue_ms_all"] = res.enqueue_ms
    rec["step_ms"] = statistics.median(res.step_ms[2:8])
    rec["enqueue_ms"] = statistics.median(res.enqueue_ms[2:8])
    tokens = seq * batch_rows
    active = active_param_count(model)
    rec["active_params"] = active
    rec["tokens_per_s"] = tokens / (rec["step_ms"] / 1e3)
    rec["model_flops"] = model_flops_train(active, tokens)
    rec["mfu"] = rec["model_flops"] / (rec["step_ms"] / 1e3) / PEAK_FLOPS_BF16
    with torch.no_grad():
        rec["loss_step0_after"] = float(model.loss_fn(params, batch0)[0])
    rec["loss_step0_before"] = res.losses[0]

    # one more step under torch.profiler: its kernels by device time
    if cuda:
        ts = make_train_step(cfg, make_host_mesh(devices=[device]),
                             total_steps=steps_n)
        state = [params, opt_state]

        def step():
            state[0], state[1], _ = ts.fn(state[0], state[1], batch0)

        rec["step_profile"] = lm_step_profile(step, calls=1)
        rec["step_syncs"] = lmt_sync_points(step)
    rec["ok"] = (all(math.isfinite(x) for x in res.losses)
                 and rec["loss_step0_after"] < rec["loss_step0_before"]
                 and rec["grad_check"]["cosine"] >= LMT_COS_MIN
                 and len(res.losses) == steps_n)
    del res, params, opt_state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def lmt_drill(name, device="cuda") -> dict:
    """Phase 10c on one reduced architecture: the ``fail_at`` drill (one
    restart, the unfailed run's final parameters bit for bit) and a
    resume from a checkpoint (the uninterrupted run's losses and final
    parameters bit for bit), with checkpoints in a temporary directory."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_loop
    from repro_torch.models.tree import tree_leaves

    cfg = get_arch(name).reduced()
    kw = dict(steps=6, global_batch=2, seq_len=64, ckpt_every=2,
              log_every=100, device=device)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))

    with tempfile.TemporaryDirectory() as tmp:
        full = train_loop(cfg, ckpt_dir=os.path.join(tmp, "a"), **kw)
        failed = train_loop(cfg, ckpt_dir=os.path.join(tmp, "b"), fail_at=4,
                            **kw)
        for s in (4, 6):
            shutil.rmtree(os.path.join(tmp, "a", f"step_{s}"))
        resumed = train_loop(cfg, ckpt_dir=os.path.join(tmp, "a"), **kw)
    rec = {"arch": name, "restarts": failed.restarts,
           "drill_params_equal": same(failed.state[0], full.state[0]),
           "drill_opt_state_equal": same(failed.state[1].inner,
                                         full.state[1].inner),
           "resumed_losses_equal": resumed.losses == full.losses[2:],
           "resumed_params_equal": same(resumed.state[0], full.state[0]),
           "losses": full.losses}
    rec["ok"] = (rec["restarts"] == 1 and full.restarts == 0
                 and rec["drill_params_equal"]
                 and rec["drill_opt_state_equal"]
                 and rec["resumed_losses_equal"]
                 and rec["resumed_params_equal"])
    return rec


def check_lm_train(card) -> dict:
    """Phase 10: 10a the ten reduced architectures on the card against
    the CPU; 10b gemma3-4b trained at full width and depth; 10c the fault
    drill and the resume on the card. Returns the ``lm_train`` record; a
    failed check raises."""
    import torch

    from repro_torch.configs import ARCHS, get_arch

    gc.collect()
    torch.cuda.empty_cache()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t_phase = time.perf_counter()
    reduced = {name: lmt_reduced_case(name) for name in sorted(ARCHS)}
    print("lm_train_reduced: " + json.dumps(reduced), flush=True)
    bad = [n for n, r in reduced.items() if not r["ok"]]
    if bad:
        raise RuntimeError(f"phase 10a failed on {bad}")
    record["reduced_s"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    full = lmt_full(get_arch(LM_ARCH), LMT_SEQ, LMT_BATCH)
    full["phase_s"] = time.perf_counter() - t0
    record["full"] = full
    if not full["ok"]:
        print("lm_train: " + json.dumps(record), flush=True)
        raise RuntimeError(f"phase 10b failed: {full}")

    t0 = time.perf_counter()
    drill = lmt_drill("starcoder2-15b")
    drill["s"] = time.perf_counter() - t0
    record["drill"] = drill
    if not drill["ok"]:
        print("lm_train: " + json.dumps(record), flush=True)
        raise RuntimeError(f"phase 10c failed: {drill}")
    record["phase_s"] = time.perf_counter() - t_phase
    return record


# -- phase 11: the sharded LM executor (distributed/sharding.py,
# distributed/executor.py, distributed/compression.py, the mesh branches of
# models/, launch/steps.py and launch/train.py on a mesh) --------------------
LMS_MESHES = {"2x2": (2, 2), "1x4": (1, 4), "1x8": (1, 8), "4x1": (4, 1)}
LMS_TOL = 1e-5             # 11a: sharded against one slot, float32
LMS_FULL_MESH = (2, 4)     # 11b: gemma3-4b, "head" with the kv heads split
LMS_KEY_MESH = (1, 16)     # 11b: the production model axis, "key"
LMS_LOSS_TOL = 1e-3        # 11b: bf16, relative
LMS_COS_MIN = 0.999        # 11b: sharded bf16 gradients against one slot's
LMS_LEAF_COS_MIN = 0.99    # 11b: the same, leaf by leaf
LMS_UPD_TOL = 5e-2         # 11b: the repo's bf16 tolerance, in units of lr
LMS_UPD_REL = 2.0 ** -6    # 11b: entries whose two gradients agree this
#                            closely (relative) have their updates held
LMS_UPD_SHARE_MIN = 0.25   # 11b: the share of entries held, at least
LMS_LR = 3e-4              # 11b: AdamW's peak rate, held constant (the
#                            schedule's rate at step 0 is 0: no update)
LMS_CHUNK = 1 << 26        # 11b: entries compared at a time


def lms_mesh(shape, device="cuda"):
    """A virtual (data, model) mesh of `shape` slots of `device`."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"),
                     devices=[device] * int(math.prod(shape)))


def lms_whole(tree) -> list:
    """The whole tensors of a placed tree's leaves, in tree order."""
    from repro_torch.distributed import elastic

    return [elastic.gather(x) for x in elastic.placed_leaves(tree)]


def lms_optimizer(opt, name):
    """``select_optimizer`` giving `opt` (the steps built inside)."""
    import unittest.mock

    from repro_torch.launch import steps

    return unittest.mock.patch.object(
        steps, "select_optimizer", lambda model, total_steps=0: (opt, name))


def lms_counts(ex) -> dict:
    return {k: dict(v) for k, v in ex.counts.items()}


def lms_mask_last_row(labels) -> None:
    """The batch's last row's labels from a third of the way on set to
    -1, in place (the lines' masked counts then differ): a whole tensor,
    or a placed leaf's blocks (at accum > 1 in the microbatch layout,
    (accum, rows, seq): the last microbatch's last row)."""
    from repro_torch.distributed import elastic

    cut = labels.shape[-1] // 3
    if not isinstance(labels, elastic.Placed):
        labels[-1, cut:] = -1
        return
    dim = len(labels.shape) - 2
    last = labels.shape[dim] - 1
    for sl, copies in elastic.logical_blocks(labels):
        lo = sl[dim].start or 0
        hi = labels.shape[dim] if sl[dim].stop is None else sl[dim].stop
        if lo <= last < hi:
            for t in copies:
                (t[-1] if dim else t)[last - lo, cut:] = -1


def lms_lines_batch(ts, data, extra=None) -> dict:
    """`data`'s batch of step 0 as the pipeline hands it to the sharded
    step `ts`: ``make_batch_iterator(shardings=)`` with the step's
    ``batch_shardings`` (each line's rows on its own slots), and the
    `extra` leaves (the frontends' inputs, whole) placed alike."""
    import torch

    from repro_torch.data.pipeline import make_batch_iterator

    tree = {k: torch.empty((data.global_batch, data.seq_len),
                           dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}
    tree.update(extra or {})
    sh = ts.batch_shardings(tree)
    it = make_batch_iterator(data, start_step=0, shardings=sh)
    try:
        batch = next(it)
    finally:
        it.close()
    if extra:
        batch.update(sh.place(extra))
    return batch


def lms_reduced_case(name, device="cuda") -> dict:
    """Phase 11a on one reduced architecture at float32: the sharded
    loss and gradients on the three meshes against the card's one-slot
    ones; one update of sgd (momentum 0.9), adamw and adafactor (its
    statistics factored: the size rule lowered to 32) from the one-slot
    gradients, placed on (2, 2) and (1, 8), against the one-slot update;
    an accum-2 SGD step on (2, 2) against the one-slot step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.optim import constant, optimizers

    from repro_torch.data import SyntheticLMData

    cfg = get_arch(name).reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    batch = lmt_reduced_batch(cfg, device)      # step 0 of `data`
    lms_mask_last_row(batch["labels"])
    data = SyntheticLMData(cfg.vocab_size, LMT_REDUCED[1], LMT_REDUCED[0],
                           seed=3)
    extra = {k: v for k, v in batch.items() if k not in ("tokens",
                                                         "labels")}

    def lines_batch(ts):
        placed = lms_lines_batch(ts, data, extra)
        lms_mask_last_row(placed["labels"])
        return placed

    l1, g1 = lmt_grads(model, params, batch)
    params = tree_map(lambda t: t.detach(), params)
    rec = {"loss_rel_err": {}, "grad_rel_err": {}, "grad_zero_level": {},
           "collectives": {}}
    for mname, shape in LMS_MESHES.items():
        ts = steps.make_train_step(cfg, lms_mesh(shape, device))
        placed = ts.params_sh.place(tree_map(torch.clone, params))
        loss, _, grads = ts.executor.grads(model.loss_fn, placed,
                                           lines_batch(ts))
        rec["loss_rel_err"][mname] = abs(float(loss) - float(l1)) / abs(
            float(l1))
        rec["grad_rel_err"][mname], rec["grad_zero_level"][mname] = \
            lmt_leaf_errs(lms_whole(grads), g1)
        rec["collectives"][mname] = lms_counts(ts.executor)

    opts = {"sgd": lambda: optimizers.sgd(constant(LMT_LR), 0.9),
            "adamw": lambda: optimizers.adamw(constant(LMT_LR),
                                              weight_decay=0.1),
            "adafactor": lambda: optimizers.adafactor(
                constant(LMT_LR), min_dim_size_to_factor=32)}
    g_tree = tree_unflatten(params, [g.clone() for g in g1])
    rec["opt_rel_err"] = {}
    for oname, make in opts.items():
        o = make()
        p = tree_map(torch.clone, params)
        p, st = o.update(g_tree, o.init(p), p)
        want = tree_leaves(p) + tree_leaves(st.inner)
        for mname in ("2x2", "1x8"):
            with lms_optimizer(make(), oname):
                ts = steps.make_train_step(
                    cfg, lms_mesh(LMS_MESHES[mname], device))
            start = tree_map(torch.clone, params)
            p = ts.params_sh.place(start)
            st = ts.opt_sh.place(ts.optimizer.init(start))
            p, st = ts.optimizer.update(ts.params_sh.place(g_tree), st, p)
            rec["opt_rel_err"][f"{oname}@{mname}"] = lmt_leaf_errs(
                lms_whole(p) + lms_whole(st.inner), want)[0]

    outs = []
    for mesh in (make_host_mesh(devices=[device]), lms_mesh((2, 2), device)):
        with lms_optimizer(optimizers.sgd(constant(LMT_LR * 100)), "sgd"):
            ts = steps.make_train_step(cfg, mesh, accum=2)
        p = tree_map(torch.clone, params)
        st = ts.optimizer.init(p)
        b = batch
        if ts.params_sh is not None:
            p, st = ts.params_sh.place(p), ts.opt_sh.place(st)
            b = lines_batch(ts)     # the microbatch layout: accum 2
        new, _, metrics = ts.fn(p, st, b)
        outs.append((float(metrics["loss"]),
                     lms_whole(new) if ts.params_sh is not None
                     else tree_leaves(new)))
    rec["accum2_loss_rel_err"] = abs(outs[1][0] - outs[0][0]) / abs(
        outs[0][0])
    rec["accum2_param_rel_err"] = lmt_leaf_errs(outs[1][1], outs[0][1])[0]
    rec["ok"] = (max(rec["loss_rel_err"].values()) <= LMS_TOL
                 and max(rec["grad_rel_err"].values()) <= LMS_TOL
                 and max(rec["grad_zero_level"].values()) <= 1e-6
                 and max(rec["opt_rel_err"].values()) <= LMS_TOL
                 and rec["accum2_loss_rel_err"] <= LMS_TOL
                 and rec["accum2_param_rel_err"] <= LMS_TOL)
    return rec


def lms_compression(device="cuda") -> dict:
    """Phase 11a's ``compressed_psum`` over 8 slots on the card: equal
    gradients within max|g|/127 of themselves (x1.01) and two steps of
    them averaging within 0.75 of that, the JAX package's test bounds;
    distinct gradients within scale/2 of the plain mean."""
    import torch

    from repro_torch.distributed.compression import (
        compressed_psum, make_error_feedback_state)

    gen = torch.Generator(device=device).manual_seed(5)
    per = [{"w": torch.randn((1024, 1024), generator=gen, device=device)}
           for _ in range(8)]
    err = [make_error_feedback_state(per[0]) for _ in range(8)]
    g = per[0]["w"]
    bound = float(g.abs().max()) / 127.0 + 1e-9
    one, err2 = compressed_psum([per[0]] * 8, err)
    two, _ = compressed_psum([per[0]] * 8, err2)
    mean, _ = compressed_psum(per, err)
    stack = torch.stack([p["w"] for p in per])
    scale = float(stack.abs().max()) / 127.0 + 1e-12
    rec = {"equal_over_bound": float((one["w"] - g).abs().max()) / bound,
           "two_step_over_bound": float(((one["w"] + two["w"]) / 2
                                         - g).abs().max()) / bound,
           "distinct_over_half_scale": float(
               (mean["w"] - stack.mean(0)).abs().max()) / (scale / 2)}
    rec["ok"] = (rec["equal_over_bound"] <= 1.01
                 and rec["two_step_over_bound"] <= 0.75
                 and rec["distinct_over_half_scale"] <= 1.0 + 1e-5)
    return rec


def lms_leaf_check(gs, g1, ps, p1, lr) -> dict:
    """Phase 11b's comparison of one leaf, the sharded step's gradient
    `gs` and updated parameter `ps` against the one-slot step's `g1` and
    `p1` (whole tensors on the card), in chunks of ``LMS_CHUNK`` entries:
    the gradients' dot and norms; and where the two gradients agree within
    ``LMS_UPD_REL`` (relative), the updated entries' difference less one
    rounding of the parameter's dtype, over `lr` (AdamW's first update
    there differs by under 0.004·lr before rounding)."""
    import torch

    eps = torch.finfo(p1.dtype).eps
    out = {"dot": 0.0, "n_s": 0.0, "n_1": 0.0, "held": 0, "numel": 0,
           "err_over_lr": 0.0}
    gs, g1, ps, p1 = (t.reshape(-1) for t in (gs, g1, ps, p1))
    for i in range(0, g1.numel(), LMS_CHUNK):
        a, b = gs[i:i + LMS_CHUNK].float(), g1[i:i + LMS_CHUNK].float()
        out["dot"] += float(torch.dot(a, b))
        out["n_s"] += float(torch.dot(a, a))
        out["n_1"] += float(torch.dot(b, b))
        held = (a - b).abs() <= LMS_UPD_REL * b.abs()
        del a, b
        x, y = ps[i:i + LMS_CHUNK].float(), p1[i:i + LMS_CHUNK].float()
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(x.abs(), y.abs())))) * eps
        err = ((x - y).abs() - ulp).clamp_(min=0.0)[held]
        out["held"] += int(held.sum())
        out["numel"] += held.numel()
        if err.numel():
            out["err_over_lr"] = max(out["err_over_lr"],
                                     float(err.max()) / lr)
        del x, y, ulp, err, held
    return out


def lms_full(cfg, shape, seq, rows, device="cuda", ref=None,
             timed=0, params=None, keep=None) -> dict:
    """Phase 11b: `cfg` at full width and depth (bf16, remat, AdamW at a
    constant ``LMS_LR``) on a virtual mesh of `shape` slots of the card,
    phase 10's parameters (seed 0) and batch (step 0), the sharded step's
    placed per line by ``make_batch_iterator(shardings=)``. Without
    `ref`: the one-slot step first (its gradients and its updated
    parameters kept on the host), then the sharded step's two calls,
    each timed by CUDA
    events with its host enqueue (the first sharded step:
    ``first_step_ms``): its gradients, then the update from them. Held
    to the one-slot step: its loss; its gradients' cosine, over all
    leaves and leaf by leaf; and its updated parameters, leaf by leaf
    (``lms_leaf_check``). Then `timed` whole sharded steps, timed
    (``step_ms``, ``enqueue_ms``: the last); the peak memory and a step's
    collective counts. With `ref` (the one-slot loss), the first timed
    step's loss is held to it. `params` replaces the seeded draw (a
    float32 copy of the bf16 weights); `keep`, a dict, receives the
    one-slot gradients (``g1``, on the host)."""
    import dataclasses

    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import elastic
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _StepClock
    from repro_torch.models import attention, build_model, shard_ctx
    from repro_torch.models.tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.optim import constant, optimizers

    cuda = torch.device(device).type == "cuda"
    cfg = dataclasses.replace(cfg, remat=True)
    model = build_model(cfg)
    data = SyntheticLMData(cfg.vocab_size, seq, rows, seed=0)
    batch0 = {k: torch.from_numpy(v).to(device)
              for k, v in data.batch(0).items()}
    if params is None:
        params = model.init_params(
            torch.Generator(device=device).manual_seed(0))

    def adamw():
        return optimizers.adamw(constant(LMS_LR), weight_decay=0.1)

    mesh = lms_mesh(shape, device)
    shard_ctx.set_axes(mesh, ("data",), ("model",))
    try:
        layout = ("head" if attention.head_tp_available(
            cfg.n_heads, cfg.n_kv_heads) else "key")
    finally:
        shard_ctx.clear()
    rec = {"arch": cfg.name, "mesh": list(shape), "seq_len": seq,
           "global_batch": rows, "remat": True, "layout": layout,
           "lr": LMS_LR}
    g1_host = p1_host = None
    if ref is None:
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss1, _ = model.loss_fn(params, batch0)
        g1 = torch.autograd.grad(loss1, leaves)
        for t in leaves:
            t.requires_grad_(False)
        ref = float(loss1.detach())
        del loss1
        o = adamw()
        p1 = tree_map(torch.clone, params)
        p1, st = o.update(tree_unflatten(params, list(g1)), o.init(p1), p1)
        del st
        g1_host = [g.cpu() for g in g1]
        if keep is not None:
            keep["g1"] = g1_host
        p1_host = [t.cpu() for t in tree_leaves(p1)]
        del g1, p1
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    rec["loss_one_slot"] = ref

    with lms_optimizer(adamw(), "adamw"):
        ts = make_train_step(cfg, mesh)
    state = ts.opt_sh.place(ts.optimizer.init(params))
    placed = ts.params_sh.place(params)      # views: updated in place
    del params
    # the pipeline's batch: each line's rows on its own slots
    lines = lms_lines_batch(ts, data)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if g1_host is not None:
        # the sharded step's two calls, each timed: the gradients, then
        # the update on the blocks from them
        clock = _StepClock(torch.device(device))
        clock.start()
        loss2, _, g2 = ts.executor.grads(model.loss_fn, placed, lines)
        grads_enq = clock.enqueued()
        rec["loss"] = float(loss2)
        rec["grads_ms"] = clock.elapsed()
        rec["collectives"] = lms_counts(ts.executor)
        clock.start()
        placed, state = ts.optimizer.update(g2, state, placed)
        update_enq = clock.enqueued()
        if cuda:
            torch.cuda.synchronize()      # nothing read back: wait here
        rec["update_ms"] = clock.elapsed()
        rec["first_step_ms"] = rec["grads_ms"] + rec["update_ms"]
        rec["first_enqueue_ms"] = grads_enq + update_enq
        dot = n_s = n_1 = 0.0
        held = numel = 0
        cos, shares, err = [], [], 0.0
        for i, (pg, pp, g1, p1) in enumerate(zip(
                elastic.placed_leaves(g2), elastic.placed_leaves(placed),
                g1_host, p1_host)):
            c = lms_leaf_check(elastic.gather(pg), g1.to(device),
                               elastic.gather(pp), p1.to(device), LMS_LR)
            dot, n_s, n_1 = dot + c["dot"], n_s + c["n_s"], n_1 + c["n_1"]
            held, numel = held + c["held"], numel + c["numel"]
            err = max(err, c["err_over_lr"])
            # a leaf whose two gradients are both zero agrees
            cos.append((c["dot"] / math.sqrt(c["n_s"] * c["n_1"])
                        if c["n_s"] * c["n_1"] > 0
                        else float(c["n_s"] == c["n_1"]), i))
            shares.append(c["held"] / c["numel"])
        del g2, g1_host, p1_host
        gc.collect()
        rec["grad_cosine"] = dot / math.sqrt(n_s * n_1)
        rec["grad_leaf_cosine_min"], rec["grad_leaf_cosine_min_leaf"] = \
            min(cos)
        rec["update_err_over_lr"] = err
        rec["update_held_share"] = held / numel
        rec["update_held_share_leaf_min"] = min(shares)

    for _ in range(timed):
        clock = _StepClock(torch.device(device))
        clock.start()
        placed, state, metrics = ts.fn(placed, state, lines)
        rec["enqueue_ms"] = clock.enqueued()
        rec.setdefault("losses", []).append(float(metrics["loss"]))
        rec["step_ms"] = clock.elapsed()
        rec["collectives"] = lms_counts(ts.executor)
    rec.setdefault("loss", rec.get("losses", [None])[0])
    rec["loss_rel_err"] = abs(rec["loss"] - ref) / abs(ref)
    if cuda:
        rec["max_memory_allocated_gb"] = (torch.cuda.max_memory_allocated()
                                          / 1e9)
    rec["ok"] = (rec["loss_rel_err"] <= LMS_LOSS_TOL
                 and all(math.isfinite(x) for x in rec.get("losses", []))
                 and rec.get("grad_cosine", 1.0) >= LMS_COS_MIN
                 and rec.get("grad_leaf_cosine_min", 1.0) >= LMS_LEAF_COS_MIN
                 and rec.get("update_err_over_lr", 0.0) <= LMS_UPD_TOL
                 and rec.get("update_held_share", 1.0) >= LMS_UPD_SHARE_MIN)
    del placed, state, ts
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def lms_drill(name, device="cuda") -> dict:
    """Phase 11c on one reduced architecture, SGD at a fixed rate: the
    loop on (2, 2) against the one-slot loop; the ``fail_at`` drill on
    (2, 2) (one restart onto the mesh, the uninterrupted run's parameters
    bit for bit); a resume from step 2 onto (1, 2), the surviving slots
    of ``shrink_mesh`` (the losses and parameters of the uninterrupted
    run within 1e-5)."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.elastic import shrink_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.tree import tree_leaves
    from repro_torch.optim import constant, optimizers

    cfg = get_arch(name).reduced()
    kw = dict(steps=6, global_batch=2, seq_len=64, ckpt_every=2,
              log_every=100, device=device)
    mesh = lms_mesh((2, 2), device)
    with lms_optimizer(optimizers.sgd(constant(0.05)), "sgd"), \
            tempfile.TemporaryDirectory() as tmp:
        one = train_loop(cfg, **kw)
        full = train_loop(cfg, mesh, ckpt_dir=os.path.join(tmp, "a"), **kw)
        failed = train_loop(cfg, mesh, ckpt_dir=os.path.join(tmp, "b"),
                            fail_at=4, **kw)
        for s in (4, 6):
            shutil.rmtree(os.path.join(tmp, "a", f"step_{s}"))
        live = shrink_mesh(mesh, [2, 3])
        small = make_mesh((1, 2), ("data", "model"),
                          devices=list(live.devices.flat[:2]))
        resumed = train_loop(cfg, small, ckpt_dir=os.path.join(tmp, "a"),
                             **kw)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    f_leaves = lms_whole(full.state[0])
    rec = {"arch": name, "restarts": failed.restarts,
           "mesh_vs_one_loss_rel_err": max(
               rel(a, b) for a, b in zip(full.losses, one.losses)),
           "mesh_vs_one_param_rel_err": lmt_leaf_errs(
               f_leaves, tree_leaves(one.state[0]))[0],
           "drill_params_equal": all(torch.equal(a, b) for a, b in zip(
               lms_whole(failed.state[0]), f_leaves)),
           "resumed_loss_rel_err": max(
               rel(a, b) for a, b in zip(resumed.losses, full.losses[2:])),
           "resumed_param_rel_err": lmt_leaf_errs(
               lms_whole(resumed.state[0]), f_leaves)[0],
           "losses": full.losses}
    rec["ok"] = (rec["restarts"] == 1 and full.restarts == 0
                 and len(resumed.losses) == 4
                 and rec["drill_params_equal"]
                 and rec["mesh_vs_one_loss_rel_err"] <= LMS_TOL
                 and rec["mesh_vs_one_param_rel_err"] <= LMS_TOL
                 and rec["resumed_loss_rel_err"] <= LMS_TOL
                 and rec["resumed_param_rel_err"] <= LMS_TOL)
    return rec


def check_lm_shard(card) -> dict:
    """Phase 11: 11a the ten reduced architectures sharded on virtual
    meshes of the card against its one-slot step, and ``compressed_psum``
    on 8 slots; 11b gemma3-4b at full width sharded on (2, 4) against the
    one-slot step, timed, and on (1, 16);
    11c the fault drill and a resume onto a smaller mesh. Returns the
    ``lm_shard`` record; a failed check raises."""
    import torch

    from repro_torch.configs import ARCHS, get_arch

    gc.collect()
    torch.cuda.empty_cache()
    record = {"card": card}
    t_phase = time.perf_counter()
    reduced = {name: lms_reduced_case(name) for name in sorted(ARCHS)}
    print("lm_shard_reduced: " + json.dumps(reduced), flush=True)
    bad = [n for n, r in reduced.items() if not r["ok"]]
    record["compression"] = lms_compression()
    if bad or not record["compression"]["ok"]:
        raise RuntimeError(f"phase 11a failed on {bad}: "
                           f"{record['compression']}")
    record["reduced_s"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    full = lms_full(get_arch(LM_ARCH), LMS_FULL_MESH, LMT_SEQ, LMT_BATCH,
                    timed=1)
    full["s"] = time.perf_counter() - t0
    record["full"] = full
    if not full["ok"]:
        print("lm_shard: " + json.dumps(record), flush=True)
        raise RuntimeError(f"phase 11b failed: {full}")
    t0 = time.perf_counter()
    key = lms_full(get_arch(LM_ARCH), LMS_KEY_MESH, LMT_SEQ, LMT_BATCH,
                   ref=full["loss_one_slot"], timed=1)
    key["s"] = time.perf_counter() - t0
    record["full_key"] = key
    if not key["ok"]:
        print("lm_shard: " + json.dumps(record), flush=True)
        raise RuntimeError(f"phase 11b failed on {LMS_KEY_MESH}: {key}")

    t0 = time.perf_counter()
    drill = lms_drill("starcoder2-15b")
    drill["s"] = time.perf_counter() - t0
    record["drill"] = drill
    if not drill["ok"]:
        print("lm_shard: " + json.dumps(record), flush=True)
        raise RuntimeError(f"phase 11c failed: {drill}")
    record["phase_s"] = time.perf_counter() - t_phase
    return record


# -- phase 12: the dry run (configs.input_specs, make_prefill_step and
# make_serve_step on a mesh, roofline/op_cost.py, launch/dryrun.py) -------
# 12e: the cells that count in seconds; the train and prefill cells take
# minutes of one core (PERF.md has them from the command line)
DRY_CELLS = ("gemma3-4b:decode_32k:pod", "icr-dust-pod:sample:pod")
DRY_TIMEOUT = 300            # 12e: seconds a cell may take
DRY_PEAK_TOL = 0.05          # 12b: predicted peak against the card's
DRY_MESHES = {"head": (2, 4), "key": (1, 16)}   # 12c, phase 11's
DRY_FROM = 124               # 12c: positions the one-slot step writes first
DRY_STEPS = 8                # 12c: decode steps compared, from DRY_FROM
DRY_PREFILL_ROWS = 2         # 12c: prompts prefilled, one per line of (2, 4)
DRY_TRAIN_ARCH = "deepseek-v2-236b"   # 12f: reduced, (2, 4), card and meta


def dry_cells_start() -> list:
    """12e: the dry run's rows of ``DRY_CELLS``, each in a process of its
    own on one CPU core (``python -m repro_torch.launch.dryrun --cell``),
    started now and read by ``dry_cells_finish``; ``dry_cells_stop`` ends
    any left."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for cell in DRY_CELLS:
        procs.append((cell, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
             cell, "--json-only"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))))
    return procs


def dry_cells_stop(procs) -> None:
    for _, _, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def dry_cells_finish(procs) -> dict:
    """12e: each cell's row (status OK) and its seconds from its start."""
    rows = {}
    for cell, t0, p in procs:
        left = max(DRY_TIMEOUT - (time.perf_counter() - t0), 1.0)
        out, err = p.communicate(timeout=left)
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"dry run {cell}: exit {p.returncode}: "
                               f"{(err or out)[-1500:]}")
        row = json.loads(lines[-1])
        row["seconds"] = time.perf_counter() - t0
        rows[cell] = row
    bad = [c for c, r in rows.items() if r["status"] != "OK"]
    if bad:
        raise RuntimeError(f"dry run cells failed: {bad}")
    return rows


def dry_constants(card) -> dict:
    """12a: the constants of ``launch/mesh.py`` beside the card's own."""
    import torch

    from repro_torch.launch import mesh as hw

    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    rec = {"card": card, "name": name, "total_memory": props.total_memory,
           "HBM_BYTES": hw.HBM_BYTES, "sm_count": props.multi_processor_count,
           "bandwidth_of_name": hw.bandwidth_of(name), "HBM_BW": hw.HBM_BW,
           "PEAK_FLOPS_BF16": hw.PEAK_FLOPS_BF16,
           "PEAK_FLOPS_F32": hw.PEAK_FLOPS_F32, "NVLINK_BW": hw.NVLINK_BW,
           "IB_BW": hw.IB_BW}
    rec["ok"] = (hw.HBM_BYTES <= props.total_memory <= 1.1 * hw.HBM_BYTES
                 and rec["bandwidth_of_name"] == hw.HBM_BW)
    return rec


def dry_one_slot(device="cuda") -> dict:
    """12b: gemma3-4b's one-slot train step at phase 10's batch (bf16,
    remat, AdamW), counted on ``meta`` (its FLOPs and its predicted peak:
    the parameters and optimizer state plus the counter's peak of what
    the step allocates) and run on the card under the same counter (its
    FLOPs) with ``max_memory_allocated`` over the step, less what was
    allocated before the parameters."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.tree import tree_leaves
    from repro_torch.roofline.analysis import analyze_step
    from repro_torch.roofline.op_cost import HOME, OpCounter

    cfg = dataclasses.replace(get_arch(LM_ARCH), remat=True)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    t0 = time.perf_counter()
    ts = make_train_step(cfg, make_host_mesh(devices=["meta"]))
    p = ts.model.params_spec()
    opt = ts.optimizer.init(p)
    static = nbytes(p) + nbytes(opt)
    batch = {k: torch.empty((LMT_BATCH, LMT_SEQ), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    _, _, meta = analyze_step(ts.fn, p, opt, batch, static={HOME: static})
    rec = {"arch": LM_ARCH, "seq_len": LMT_SEQ, "global_batch": LMT_BATCH,
           "meta_flops": meta.flops, "meta_bytes": meta.bytes,
           "meta_ops": meta.ops, "static_bytes": static,
           "predicted_peak_bytes": static + meta.peak[HOME],
           "meta_s": time.perf_counter() - t0}
    del ts, p, opt

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ts = make_train_step(cfg, make_host_mesh(devices=[device]))
    params = ts.model.init_params(
        torch.Generator(device=device).manual_seed(0))
    opt = ts.optimizer.init(params)
    data = SyntheticLMData(cfg.vocab_size, LMT_SEQ, LMT_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with OpCounter() as card_count:
        _, _, metrics = ts.fn(params, opt, batch)
    torch.cuda.synchronize()
    rec.update(card_flops=card_count.flops, card_ops=card_count.ops,
               card_loss=float(metrics["loss"]), base_bytes=base,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               card_s=time.perf_counter() - t0)
    rec["measured_peak_bytes"] = rec["max_memory_allocated"] - base
    rec["peak_rel_err"] = (rec["predicted_peak_bytes"]
                           / rec["measured_peak_bytes"] - 1.0)
    rec["ok"] = (rec["meta_flops"] == rec["card_flops"] > 0
                 and abs(rec["peak_rel_err"]) <= DRY_PEAK_TOL
                 and math.isfinite(rec["card_loss"]))
    del ts, params, opt, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def dry_mesh_case(cfg, params, layout, prompt, toks, cache0,
                  device="cuda", *, shape=None, start=DRY_FROM,
                  n_steps=DRY_STEPS, s_max=LM_S_MAX, meta=True,
                  logits=None) -> dict:
    """12c on one virtual mesh of the card (``DRY_MESHES[layout]``, or
    `shape`): the prefill of `prompt` against one slot, and `n_steps`
    decode steps of `toks` (rows: requests, teacher forced) at positions
    `start` on from `cache0` (positions before them written by the
    one-slot step) against one slot at bf16: logits within ``LM_TF_TOL``
    of the largest, decode argmax equal at every step and row, the cache
    after them within ``LM_TF_TOL`` of the one-slot cache leaf by leaf;
    and (`meta`) each step's collective counts against the same step's on
    a mesh of ``meta`` slots. `logits`, a dict, receives the prefill's
    logits, one slot's (``one``) and the mesh's (``mesh``)."""
    import torch

    from repro_torch.distributed import elastic
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.tree import tree_leaves, tree_map

    shape = shape or DRY_MESHES[layout]
    rows = toks.shape[0]
    rec = {"layout": layout, "mesh": list(shape), "rows": rows,
           "positions": [start, start + n_steps - 1],
           "prompt_len": prompt.shape[1]}
    t0 = time.perf_counter()
    model, _, one_for = make_prefill_step(cfg, lms_mesh((1, 1), device))
    batch = {"tokens": prompt}
    ref = one_for(batch)[0](params, batch)
    _, p_sh, fn_for = make_prefill_step(cfg, lms_mesh(shape, device))
    placed = p_sh.place(params)
    fn, b_sh = fn_for(batch)
    # the prompts placed per line; the logits come back per line
    got = elastic.gather(fn(placed, b_sh.place(batch)))
    if logits is not None:
        logits.update(one=ref, mesh=got)
    rec["prefill_rel_err"] = float((got - ref).abs().max()
                                   / ref.abs().max())
    rec["prefill_counts"] = lms_counts(fn.executor)
    if meta:
        _, mp_sh, mfn_for = make_prefill_step(cfg, lms_mesh(shape, "meta"))
        mbatch = {"tokens": torch.empty(prompt.shape, dtype=torch.int32,
                                        device="meta")}
        mfn, mb_sh = mfn_for(mbatch)
        mfn(mp_sh.place(model.params_spec()), mb_sh.place(mbatch))
        rec["prefill_counts_equal"] = lms_counts(mfn.executor) == \
            rec["prefill_counts"]
    rec["prefill_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, one, _, _, _ = make_serve_step(cfg, lms_mesh((1, 1), device), rows,
                                      s_max)
    cache1 = tree_map(torch.clone, cache0)
    _, step, _, c_sh, c_spec = make_serve_step(cfg, lms_mesh(shape, device),
                                               rows, s_max)
    cache = c_sh.place(tree_map(torch.clone, cache0))
    err, agree = 0.0, 0
    for p in range(start, start + n_steps):
        tok = toks[:, p:p + 1]
        pos = torch.full((rows,), p, dtype=torch.int32, device=device)
        want = one(params, cache1, tok, pos)
        rows_in = step.batch_sh.place({"tokens": tok, "positions": pos})
        got = elastic.gather(step(placed, cache, rows_in["tokens"],
                                  rows_in["positions"]))
        err = max(err, float((got - want).abs().max() / want.abs().max()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    rec["decode_rel_err"] = err
    rec["argmax_equal"] = agree
    rec["argmax_total"] = rows * n_steps
    rec["cache_rel_err"] = max(
        float((g.float() - w.float()).abs().max()
              / w.float().abs().max().clamp_min(1e-30))
        for g, w in zip(lms_whole(cache), tree_leaves(cache1)))
    rec["decode_counts"] = lms_counts(step.executor)
    if meta:
        _, mstep, mp_sh, mc_sh, mc_spec = make_serve_step(
            cfg, lms_mesh(shape, "meta"), rows, s_max)
        meta_in = mstep.batch_sh.place(
            {"tokens": torch.empty((rows, 1), dtype=torch.int32,
                                   device="meta"),
             "positions": torch.empty((rows,), dtype=torch.int32,
                                      device="meta")})
        mstep(mp_sh.place(model.params_spec()), mc_sh.place(mc_spec),
              meta_in["tokens"], meta_in["positions"])
        rec["decode_counts_equal"] = lms_counts(mstep.executor) == \
            rec["decode_counts"]
    rec["decode_s"] = time.perf_counter() - t0
    rec["ok"] = (rec["prefill_rel_err"] <= LM_TF_TOL
                 and rec["decode_rel_err"] <= LM_TF_TOL
                 and rec["cache_rel_err"] <= LM_TF_TOL
                 and agree == rec["argmax_total"]
                 and rec.get("prefill_counts_equal", True)
                 and rec.get("decode_counts_equal", True))
    del placed, cache, cache1
    return rec


def dry_mesh(device="cuda") -> dict:
    """12c: gemma3-4b at full width (bf16, seeded weights) on the virtual
    meshes of ``DRY_MESHES``: a prefill of ``DRY_PREFILL_ROWS`` prompts of
    ``LM_DECODE_LEN`` tokens, and
    phase 9's ``LM_REQUESTS`` requests (a prompt shorter than ``DRY_FROM
    + DRY_STEPS`` tokens repeated) written by the one-slot serve step at
    positions 0..``DRY_FROM`` - 1 (s_max ``LM_S_MAX``), then stepped on
    each mesh and on one slot from that cache."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model

    cfg = get_arch(LM_ARCH)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    toks = torch.tensor(np.stack([np.resize(p, DRY_FROM + DRY_STEPS)
                                  for p in prompts]),
                        dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size,
                           (DRY_PREFILL_ROWS, LM_DECODE_LEN), generator=gen,
                           device=device, dtype=torch.int32)
    with torch.no_grad():
        _, one, _, _, _ = make_serve_step(cfg, lms_mesh((1, 1), device),
                                          LM_REQUESTS, LM_S_MAX)
        cache0 = model.init_cache(LM_REQUESTS, LM_S_MAX, device=device)
        for p in range(DRY_FROM):
            one(params, cache0, toks[:, p:p + 1],
                torch.full((LM_REQUESTS,), p, dtype=torch.int32,
                           device=device))
        out = {layout: dry_mesh_case(cfg, params, layout, prompt, toks,
                                     cache0, device)
               for layout in DRY_MESHES}
    del params, cache0
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def dry_mesh_train(device="cuda") -> dict:
    """12f: one train step of reduced ``DRY_TRAIN_ARCH`` (float32, AdamW)
    on the (2, 4) virtual mesh, the batch placed per line, under
    ``op_cost.OpCounter`` on the card and on ``meta`` slots: FLOPs equal
    exactly, and each owner's peak (what the counter sees the step
    allocate: each line's activations on slot (d, 0), the model slots'
    bodies, the home's reduced statistics) within ``DRY_PEAK_TOL``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.roofline.op_cost import OpCounter

    cfg = get_arch(DRY_TRAIN_ARCH).reduced()
    b, s = LMT_REDUCED
    counted = {}
    for dev in ("meta", device):
        t0 = time.perf_counter()
        ts = make_train_step(cfg, lms_mesh(LMS_FULL_MESH, dev))
        if dev == "meta":
            p = ts.model.params_spec()
            batch = {k: torch.empty((b, s), dtype=torch.int32, device=dev)
                     for k in ("tokens", "labels")}
        else:
            p = ts.model.init_params(
                torch.Generator(device=dev).manual_seed(0))
            data = SyntheticLMData(cfg.vocab_size, s, b, seed=3)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(0).items()}
        args = (ts.params_sh.place(p), ts.opt_sh.place(ts.optimizer.init(p)),
                ts.batch_shardings(batch).place(batch))
        with OpCounter() as c:
            _, _, metrics = ts.fn(*args)
        loss = metrics["loss"]
        counted[dev] = (c, None if dev == "meta" else float(loss),
                        time.perf_counter() - t0)
        del ts, p, args
    (meta, _, meta_s), (card, loss, card_s) = counted["meta"], \
        counted[device]
    owners = sorted(set(meta.peak) | set(card.peak), key=str)
    peaks = {str(o): [meta.peak[o], card.peak[o]] for o in owners}
    errs = [abs(c / m - 1.0) if m else float(c != 0)
            for m, c in peaks.values()]
    rec = {"arch": DRY_TRAIN_ARCH, "mesh": list(LMS_FULL_MESH),
           "rows": b, "seq_len": s, "meta_flops": meta.flops,
           "card_flops": card.flops, "meta_ops": meta.ops,
           "card_ops": card.ops, "peak_bytes": peaks,
           "peak_rel_err_max": max(errs), "card_loss": loss,
           "meta_s": meta_s, "card_s": card_s}
    rec["ok"] = (rec["meta_flops"] == rec["card_flops"] > 0
                 and rec["peak_rel_err_max"] <= DRY_PEAK_TOL
                 and math.isfinite(loss))
    return rec


def dry_icr(device="cuda") -> dict:
    """12d: phase 7's sharded dust and log-twin applies (S = 8, f32 and
    bf16, 8 slots of one card) against ``dryrun.icr_geometry`` on the
    same ring: launches per kernel and the halo bytes taken from ring
    neighbours."""
    import torch

    from repro_torch import ICR, matern32
    from repro_torch.core.distributed import DistributedICR
    from repro_torch.launch.dryrun import icr_geometry

    out = {}
    for (cname, dname), seen in DIST_DRY.items():
        if cname not in ("dust", "log_reflect"):
            continue
        mesh = dist_mesh("space", device)
        dist = DistributedICR(ICR(seen["chart"], matern32.with_defaults(
            rho=1.0), device="meta"), mesh, shard_axis=seen["axis"])
        dtype = torch.bfloat16 if dname == "bfloat16" else torch.float32
        geo = icr_geometry(dist, samples=S, dtype=dtype,
                           devices=len(mesh.distinct_devices()))
        rec = {"launches": geo["launches"],
               "launches_phase7": seen["launches"],
               "halo_bytes": sum(geo["halo_bytes"]),
               "halo_bytes_phase7": seen["halo_bytes_moved"]}
        rec["ok"] = (rec["launches"] == rec["launches_phase7"]
                     and rec["halo_bytes"] == rec["halo_bytes_phase7"] > 0)
        out[f"{cname}-{dname}"] = rec
    return out


def check_dryrun(card) -> dict:
    """Phase 12: 12a the card's constants, 12b the one-slot train step
    counted on ``meta`` against the card, 12c the sharded prefill and
    serve steps against one slot, 12f a reduced sharded train step
    counted on the card against ``meta``, 12d the ICR geometry against
    phase 7,
    12e the dry run's rows (after the card's work, so that they share
    the host with no timed phase). Returns the ``dryrun`` record; a
    failed check raises."""
    t_phase = time.perf_counter()
    record = {"constants": dry_constants(card)}
    print("constants: " + json.dumps(record["constants"]), flush=True)
    if not record["constants"]["ok"]:
        raise RuntimeError(f"phase 12a: {record['constants']}")
    record["one_slot"] = dry_one_slot()
    print("dryrun_one_slot: " + json.dumps(record["one_slot"]), flush=True)
    if not record["one_slot"]["ok"]:
        raise RuntimeError(f"phase 12b: {record['one_slot']}")
    record["mesh"] = dry_mesh()
    print("dryrun_mesh: " + json.dumps(record["mesh"]), flush=True)
    bad = [k for k, r in record["mesh"].items() if not r["ok"]]
    if bad:
        raise RuntimeError(f"phase 12c failed on {bad}")
    record["mesh_train"] = dry_mesh_train()
    print("dryrun_mesh_train: " + json.dumps(record["mesh_train"]),
          flush=True)
    if not record["mesh_train"]["ok"]:
        raise RuntimeError(f"phase 12f: {record['mesh_train']}")
    record["icr"] = dry_icr()
    bad = [k for k, r in record["icr"].items() if not r["ok"]]
    if bad or len(record["icr"]) != 4:
        raise RuntimeError(f"phase 12d failed: {record['icr']}")
    record["gpu_s"] = time.perf_counter() - t_phase
    procs = dry_cells_start()
    try:
        record["cells"] = dry_cells_finish(procs)
    finally:
        dry_cells_stop(procs)
    record["phase_s"] = time.perf_counter() - t_phase
    return record


# -- phase 13: the mixers' tensor-parallel forms (MLA, Mamba2/SSD, mLSTM,
# sLSTM, the MoE router, the stub frontends) on virtual meshes -------------
TP_PROMPT = 1024             # 13a/13b: tokens a prompt
TP_FROM = 16                 # positions the one-slot step writes first
TP_S_MAX = 64                # the decode cache's positions
# arch -> (mesh, rows: one prompt a line, prompt tokens, decode steps in
# float32 / bf16, the bf16 counts against meta's)
TP_CASES = {"zamba2-7b": (((2, 4), 2, TP_PROMPT, 8, 2, False),
                          ((1, 16), 1, 256, 4, 2, False)),
            "deepseek-v2-236b": (((2, 4), 2, TP_PROMPT, 8, 8, True),)}
TP_DEEPSEEK_LAYERS = 3       # 13b: the leading dense layer, two MoE layers
TP_F32_TOL = 1e-3            # float32 runs: mesh against one slot
TP_BF16_RATIO = 2.0          # bf16: the mesh's distance to the float32
#                              logits against one slot's, at most
TP_XLSTM = "xlstm-1.3b"      # 13c: one AdamW step, full width and depth
TP_XLSTM_SEQ, TP_XLSTM_ROWS = 64, 2    # one mLSTM chunk a row (the sLSTM
#                              token loop runs op by op: 29 s a step at 256)
TP_MESH = (2, 4)             # 13c, and the peaks of ``--tp-peaks``


def tp_arch(name):
    """`name`'s full-width config; deepseek-v2's depth cut to its leading
    dense layer and two MoE layers."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(name)
    if name == "deepseek-v2-236b":
        cfg = dataclasses.replace(cfg, n_layers=TP_DEEPSEEK_LAYERS)
    return cfg


def tp_prefill_peak(cfg, params, shape, prompt, device="cuda") -> float:
    """GB the sharded prefill of `prompt` on a virtual mesh of `shape`
    allocates at its peak above what the card held before it (the
    placed parameters included there)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step

    _, p_sh, fn_for = make_prefill_step(cfg, lms_mesh(shape, device))
    placed = p_sh.place(params)
    batch = {"tokens": prompt}
    fn, b_sh = fn_for(batch)
    rows = b_sh.place(batch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(placed, rows)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del placed, rows
    return peak


def tp_train_peak(cfg, shape, device="cuda") -> float:
    """GB the sharded gradients of ``TP_XLSTM_ROWS`` × ``TP_XLSTM_SEQ``
    tokens (bf16, remat) allocate at their peak above the placed
    parameters."""
    import dataclasses

    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step

    cfg = dataclasses.replace(cfg, remat=True)
    ts = make_train_step(cfg, lms_mesh(shape, device))
    placed = ts.params_sh.place(ts.model.init_params(
        torch.Generator(device=device).manual_seed(0)))
    data = SyntheticLMData(cfg.vocab_size, TP_XLSTM_SEQ, TP_XLSTM_ROWS,
                           seed=0)
    if hasattr(ts, "batch_shardings"):
        batch = lms_lines_batch(ts, data)
    else:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(0).items()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ts.executor.grads(ts.model.loss_fn, placed, batch)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del ts, placed, batch
    return peak


def tp_serve(name, device="cuda") -> dict:
    """13a/13b: `name` at full width (seeded weights; deepseek-v2's depth
    cut) on each mesh of ``TP_CASES``: `rows` prompts prefilled (one a
    line), then `rows` requests written by the one-slot serve step at
    positions 0..``TP_FROM`` - 1 and stepped on the mesh and on one slot
    from that cache (12c's checks: ``dry_mesh_case``, each dtype against
    one slot in its own dtype): in bf16 (the collective counts against
    ``meta``'s where asked), then in float32 (the same weights
    widened). Beside each bf16 prefill its distance to the
    float32 one-slot prefill, one slot's (``bf16_one_vs_f32``: bf16's own
    rounding through the model's depth) and the mesh's."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.tree import tree_map

    cfg = tp_arch(name)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(3)
    cases = []
    for shape, rows, length, n32, n16, meta in TP_CASES[name]:
        toks = torch.randint(0, cfg.vocab_size,
                             (rows, TP_FROM + max(n32, n16)), generator=gen,
                             device=device, dtype=torch.int32)
        prompt = torch.randint(0, cfg.vocab_size, (rows, length),
                               generator=gen, device=device,
                               dtype=torch.int32)
        cases.append((shape, {"float32": n32, "bfloat16": n16}, meta, toks,
                      prompt))
    out = {"arch": name, "n_layers": cfg.n_layers,
           "params": model.param_count()}
    keep: dict = {}
    for dt in ("bfloat16", "float32"):
        if dt == "float32":
            cfg = dataclasses.replace(cfg, param_dtype=dt, act_dtype=dt)
            params = tree_map(lambda t: t.float(), params)
            gc.collect()
        for shape, steps, meta, toks, prompt in cases:
            t0 = time.perf_counter()
            key = "x".join(str(n) for n in shape)
            n_steps, rows = steps[dt], toks.shape[0]
            with torch.no_grad():
                _, one, _, _, _ = make_serve_step(
                    cfg, lms_mesh((1, 1), device), rows, TP_S_MAX)
                cache0 = build_model(cfg).init_cache(rows, TP_S_MAX,
                                                     device=device)
                for p in range(TP_FROM):
                    one(params, cache0, toks[:, p:p + 1],
                        torch.full((rows,), p, dtype=torch.int32,
                                   device=device))
                keep[dt, key] = {}
                rec = dry_mesh_case(
                    cfg, params, "tp", prompt, toks[:, :TP_FROM + n_steps],
                    cache0, device, shape=shape, start=TP_FROM,
                    n_steps=n_steps, s_max=TP_S_MAX,
                    meta=meta and dt == "bfloat16", logits=keep[dt, key])
                del cache0
            rec["s"] = time.perf_counter() - t0
            out.setdefault(key, {})[dt] = rec
    for key, rec in out.items():
        if not isinstance(rec, dict):
            continue
        ref = keep["float32", key]["one"]
        for who in ("one", "mesh"):
            got = keep["bfloat16", key][who]
            rec[f"bf16_{who}_vs_f32"] = float(
                (got.float() - ref).abs().max() / ref.abs().max())
        f32, bf16 = rec["float32"], rec["bfloat16"]
        f32["ok"] = (max(f32["prefill_rel_err"], f32["decode_rel_err"],
                         f32["cache_rel_err"]) <= TP_F32_TOL
                     and f32["argmax_equal"] == f32["argmax_total"])
        bf16["ok"] = (rec["bf16_mesh_vs_f32"]
                      <= TP_BF16_RATIO * rec["bf16_one_vs_f32"]
                      and math.isfinite(bf16["decode_rel_err"])
                      and bf16.get("prefill_counts_equal", True)
                      and bf16.get("decode_counts_equal", True))
    del params, keep
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_cosine(a: list, b: list, device="cuda") -> tuple:
    """(cosine over all leaves, the least leaf cosine) of two gradient
    lists on the host, leaf by leaf in float64 on `device`."""
    dot = na = nb = 0.0
    least = 1.0
    for x, y in zip(a, b):
        x, y = x.to(device).double(), y.to(device).double()
        d, sx, sy = float((x * y).sum()), float((x * x).sum()), \
            float((y * y).sum())
        dot, na, nb = dot + d, na + sx, nb + sy
        least = min(least, d / math.sqrt(sx * sy) if sx * sy > 0
                    else float(sx == sy))
    return dot / math.sqrt(na * nb), least


def check_lm_tp(card, device="cuda") -> dict:
    """Phase 13: 13a zamba2-7b and 13b deepseek-v2 (depth cut) prefilled
    and decoded on virtual meshes of the card against one slot
    (``tp_serve``); 13c one sharded AdamW step of xlstm-1.3b on (2, 4)
    against the one-slot step (phase 11b's ``lms_full``), in bf16 and in
    float32 (the bf16 weights widened). The float32 runs hold the forms
    to one slot: logits, decode and cache within ``TP_F32_TOL``, argmax
    equal; xlstm's loss within ``LMS_LOSS_TOL``, its gradient cosine >=
    ``LMS_COS_MIN`` over all leaves and >= ``LMS_LEAF_COS_MIN`` leaf by
    leaf. The bf16 runs are the production dtype: finite, their
    collective counts equal ``meta``'s, their prefill no farther than
    ``TP_BF16_RATIO`` times one slot's bf16 prefill from the float32
    logits (bf16's rounding grows through the seeded models' depth:
    ``bf16_one_vs_f32``); xlstm's bf16 gradients' cosine to one slot's
    beside that of one slot's bf16 gradients to its float32 ones. Every
    part runs; then a failed check raises. Returns the ``lm_tp``
    record."""
    import dataclasses

    import torch

    from repro_torch.models import build_model
    from repro_torch.models.tree import tree_map

    record = {"card": card}
    t_phase = time.perf_counter()
    bad = []
    for name in TP_CASES:
        t0 = time.perf_counter()
        record[name] = tp_serve(name, device)
        record[name]["s"] = time.perf_counter() - t0
        bad += [(name, key, dt) for key, r in record[name].items()
                if isinstance(r, dict) for dt in ("bfloat16", "float32")
                if not r[dt]["ok"]]
    t0 = time.perf_counter()
    cfg = tp_arch(TP_XLSTM)
    keep16, keep32 = {}, {}
    xl = lms_full(cfg, TP_MESH, TP_XLSTM_SEQ, TP_XLSTM_ROWS, device,
                  keep=keep16)
    xl["ok"] = math.isfinite(xl["loss"])
    params = tree_map(lambda t: t.float(), build_model(cfg).init_params(
        torch.Generator(device=device).manual_seed(0)))
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    xl32 = lms_full(cfg32, TP_MESH, TP_XLSTM_SEQ, TP_XLSTM_ROWS, device,
                    params=params, keep=keep32)
    del params
    # the update's held share is phase 11b's (gemma3-4b) check: reported
    xl32["ok"] = (xl32["loss_rel_err"] <= LMS_LOSS_TOL
                  and xl32["grad_cosine"] >= LMS_COS_MIN
                  and xl32["grad_leaf_cosine_min"] >= LMS_LEAF_COS_MIN)
    xl["one_bf16_vs_f32_cosine"], xl["one_bf16_vs_f32_leaf_cosine_min"] = \
        tp_cosine(keep16["g1"], keep32["g1"], device)
    del keep16, keep32
    record[TP_XLSTM] = {"bfloat16": xl, "float32": xl32,
                        "s": time.perf_counter() - t0}
    bad += [(TP_XLSTM, dt) for dt, r in record[TP_XLSTM].items()
            if isinstance(r, dict) and not r["ok"]]
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    record["phase_s"] = time.perf_counter() - t_phase
    if bad:
        print("lm_tp: " + json.dumps(record), flush=True)
        raise RuntimeError(f"phase 13 failed on {bad}")
    return record


def tp_peaks_one(src: str) -> dict:
    """Phase 13's sharded steps on (2, 4) with the package under `src`:
    the peak GB of zamba2-7b's and deepseek-v2's (depth cut) prefill of
    two prompts and of xlstm-1.3b's gradients (``tp_prefill_peak``,
    ``tp_train_peak``)."""
    import torch

    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.models import build_model

    rec = {"src": src}
    for name in TP_CASES:
        cfg = tp_arch(name)
        params = build_model(cfg).init_params(
            torch.Generator(device="cuda").manual_seed(0))
        prompt = torch.randint(0, cfg.vocab_size, (2, TP_PROMPT),
                               generator=torch.Generator(
                                   device="cuda").manual_seed(3),
                               device="cuda", dtype=torch.int32)
        with torch.no_grad():
            rec[name] = tp_prefill_peak(cfg, params, TP_MESH, prompt)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    rec[TP_XLSTM] = tp_train_peak(tp_arch(TP_XLSTM), TP_MESH)
    return rec


def tp_peaks_ab(specs) -> int:
    """``--tp-peaks LABEL=SRC ...``: ``tp_peaks_one`` of each package in
    turn, one process each; prints one ``tp_peaks`` line per run and the
    card."""
    for spec in specs:
        label, _, src = spec.partition("=")
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--tp-peaks-one", src],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print("tp_peaks: " + json.dumps({"label": label, **rec}), flush=True)
    print(card_line())
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import ICR
    from repro_torch.core import graphs
    from repro_torch.core.refine import build_checks
    from repro_torch.kernels import build, launch

    # every graph the run captures, its kernel nodes and their plans
    graphs.CAPTURES = collections.deque()
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    from repro_torch.launch.mesh import bandwidth_of

    bandwidth = bandwidth_of(name)
    if bandwidth is None:
        print(f"chip_smoke: no bandwidth known for {name!r}",
              file=sys.stderr)
        return 1

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    for lib in build.SIGNATURES:
        build.library(lib)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(build.SIGNATURES)} libraries; card: {card}", flush=True)

    gen = torch.Generator(device="cuda")
    models = {}
    for cname, (chart, kernel) in charts().items():
        icr = ICR(chart, kernel, use_pallas=True)
        t0 = time.perf_counter()
        mats = icr.matrices()
        torch.cuda.synchronize()
        models[cname] = (icr, mats, time.perf_counter() - t0)
    from repro_torch.analysis.lint import ptxas_lines

    print("ptxas: " + json.dumps(ptxas_lines(main_path_smem(models))),
          flush=True)

    # -- 2. each kernel against its plain version -------------------------------
    errors = check_kernels(models, gen)
    print("kernels: " + json.dumps(
        {k: {d: {"max_abs_err": e[0], "max_rel_err": e[1]}
             for d, e in v.items()} for k, v in errors.items()}),
          flush=True)
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 3. the sampling path, with the pyramid and per level ------------------
    launches, path_err, covers = check_path(models, gen)
    launches = collections.Counter(launches)
    print("path: " + json.dumps({"launches": launches, "covers": covers,
                                 "max_rel_err": path_err}), flush=True)

    # -- 4. training through the adjoint kernels and nd-axes --------------------
    problems = train_problems(models, gen)
    eig = eig_cases(problems)
    eig_errors = check_sym_eig(eig)
    print("sym_eig: " + json.dumps(eig_errors), flush=True)
    train_launches, train = check_train(problems, gen)
    for k, n in train_launches.items():
        launches[k] += n
    print("train: " + json.dumps(train), flush=True)
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 4b. the compiled paths as CUDA graphs, against eager ---------------
    graph_launches, graph_record = check_graphs(problems, models, gen)
    for k, n in graph_launches.items():
        launches[k] += n
    print("graphs: " + json.dumps(graph_record), flush=True)
    print(f"phase 4b done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 5. serving: one CUDA graph per slab ------------------------------------
    flush = torch.empty(512 * 2**20, dtype=torch.float32, device="cuda")
    serve_launches, serve = check_serve(flush, bandwidth, card)
    for k, n in serve_launches.items():
        launches[k] += n
    print("serve: " + json.dumps(serve), flush=True)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 6. data-conditioned solves: cg_posterior and kind="condition" ------
    for k, n in check_condition(flush, card).items():
        launches[k] += n
    print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 7. distributed: a mesh of 8 slots over the visible cards -----------
    with launch.recording() as sharded_plans:
        for k, n in check_distributed(models, flush, gen, card).items():
            launches[k] += n
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 7b. launch plans and the static-analysis layer ---------------------
    phase_s = check_analysis(models, problems, gen, sharded_plans)
    del sharded_plans
    print(f"phase 7b done at {time.perf_counter() - t_start:.1f} s "
          f"({phase_s:.1f} s)", flush=True)

    # -- 8. times ---------------------------------------------------------------
    times = kernel_times(models, bandwidth, flush, gen)
    entries = []
    for kname, info in KERNEL_INFO.items():
        f32 = times[kname]["float32"]
        entry = {"name": kname, "route": "cuda", "source": info["source"],
                 "replaces": info["replaces"],
                 "replaces_fn": info["replaces_fn"],
                 "launches": launches[kname],
                 "max_abs_err": errors[kname]["float32"][0],
                 "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                 "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
                 "library_ms": f32["library_ms"],
                 "max_rel_err": {d: e[1] for d, e in errors[kname].items()},
                 "chart": info["chart"], "per_dtype": times[kname]}
        entries.append(entry)
        print(json.dumps(entry), flush=True)
    eig_times = sym_eig_times(eig, bandwidth, flush)
    head = eig_times[next(k for k in eig if k.startswith("log_polar_theta"))]
    entry = {"name": EIG, "route": "cuda", "source": EIG_INFO["source"],
             "replaces": EIG_INFO["replaces"],
             "replaces_fn": EIG_INFO["replaces_fn"],
             "launches": launches[EIG],
             "max_abs_err": max(e["max_abs_err"] for e in eig_errors.values()),
             "ms": head["ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"],
             "max_rel_err": {"float32": max(e["max_rel_err"]
                                            for e in eig_errors.values())},
             "chart": "log_polar_theta", "per_batch": eig_times}
    entries.append(entry)
    print(json.dumps(entry), flush=True)

    whole = {}
    for cname, (icr0, mats, mats_s) in models.items():
        for pol in (None, "bf16"):
            icr = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                      dtype_policy=pol)
            m = icr.matrices()
            per_level = ICR(icr0.chart, icr0.kernel, use_pallas=True,
                            dtype_policy=pol, use_pyramid=False)
            gen.manual_seed(11)
            xi = icr.init_xi(gen, batch=S)
            v = torch.randn((S,) + icr.out_shape, generator=gen,
                            device="cuda").to(icr.policy.storage_dtype)

            def sqrt_t(icr=icr, m=m, v=v):
                return icr.apply_sqrt_T_batch(m, v)

            def sqrt_t_eager(icr=icr, m=m, v=v):
                return icr.apply_sqrt_T_batch(m, v, cached=False)

            whole[f"{cname}-{pol or 'fp32'}"] = {
                # the transpose: a replay of its cached graph (input copy
                # and output copies included) against the chain op by op
                "apply_sqrt_T_graph_ms": time_ms(sqrt_t, flush),
                "apply_sqrt_T_eager_ms": time_ms(sqrt_t_eager, flush),
                "apply_sqrt_T_graph_enqueue_ms": enqueue_ms(sqrt_t),
                "apply_sqrt_T_eager_enqueue_ms": enqueue_ms(sqrt_t_eager),
                "apply_ms": time_ms(lambda: icr.apply_sqrt_batch(m, xi),
                                    flush),
                "apply_per_level_ms": time_ms(
                    lambda: per_level.apply_sqrt_batch(m, xi), flush),
                "plain_apply_ms": time_ms(lambda: plain_apply(icr, m, xi),
                                          flush),
                "apply_enqueue_ms": enqueue_ms(
                    lambda: icr.apply_sqrt_batch(m, xi)),
                "apply_per_level_enqueue_ms": enqueue_ms(
                    lambda: per_level.apply_sqrt_batch(m, xi)),
                "cover": covers[f"{cname}-{pol or 'fp32'}"],
                "matrices_s": mats_s, "points": icr.chart.size,
                "samples": S}
    print("whole_path: " + json.dumps(whole), flush=True)
    print("pyramid_covers: " + json.dumps(pyramid_covers(models, flush, gen)),
          flush=True)
    print("levels_fp32: " + json.dumps(level_split(models, flush, gen)),
          flush=True)
    # the learned-θ steps' builds keep their statuses on the device while
    # they are timed, and are read once after (refine.build_checks)
    with build_checks():
        steps = train_step_times(problems, flush)
    print("train_step: " + json.dumps(steps), flush=True)
    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 9. LM serving: ten reduced archs, gemma3-4b at full width ----------
    del flush
    print("lm_serve: " + json.dumps(check_lm(card)), flush=True)
    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 10. LM training: ten reduced archs, gemma3-4b at full width -------
    print("lm_train: " + json.dumps(check_lm_train(card)), flush=True)
    print(f"phase 10 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 11. the sharded LM executor: reduced archs, gemma3-4b sharded -----
    print("lm_shard: " + json.dumps(check_lm_shard(card)), flush=True)
    print(f"phase 11 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 12. the dry run: constants, meta against the card, mesh steps -----
    print("dryrun: " + json.dumps(check_dryrun(card)), flush=True)
    print(f"phase 12 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # -- 13. the mixers' tensor-parallel forms at full width ---------------
    print("lm_tp: " + json.dumps(check_lm_tp(card)), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


# fit steps per timed call of the eager-step comparison
EAGER_STEPS = 20


def eager_step_one(src: str, variant: str) -> dict:
    """The eager dust fixed-θ fit (``map_fit``, op by op) of the package
    under `src`: ms per step by CUDA events and its host enqueue, and the
    loss alone and the loss with its gradient, each way; then (``whole``)
    each chart's apply and transpose enqueue, the apply's and a 1-D
    wrapper's host ms per call (``host_ms_per_call``) and the learned-θ
    steps (``train_step_times``). ``fpad`` swaps
    ``reflect_pad`` for F.pad alone (``core.refine._pad``) in every module
    that calls it."""
    import importlib
    import inspect

    import torch

    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import (ICR, charted_gp_dataset,
                             gaussian_log_likelihood, map_fit, neg_log_joint)
    from repro_torch.kernels import build

    build.build()
    for lib in build.SIGNATURES:
        build.library(lib)
    if variant == "fpad":
        from repro_torch.core import refine

        for name in ("core.refine", "kernels.dispatch", "kernels.pyramid",
                     "kernels.nd", "kernels.nd_fused"):
            importlib.import_module("repro_torch." + name).reflect_pad = (
                refine._pad)
    chart, kernel = charts()["dust"]
    icr = ICR(chart, kernel, use_pallas=True)
    mats = icr.matrices()
    gen = torch.Generator(device="cuda").manual_seed(21)
    _, obs_idx, y = charted_gp_dataset(icr, gen, obs_frac=OBS_FRAC,
                                       noise_std=NOISE)
    ll = gaussian_log_likelihood(NOISE, obs_idx)

    def fwd(xi):
        return icr.apply_sqrt(mats, xi)

    loss_fn = neg_log_joint(ll, fwd)
    xi = [x.clone().requires_grad_(True) for x in icr.zero_xi()]
    kw = ({"jit": False} if "jit" in inspect.signature(map_fit).parameters
          else {})

    def loss():
        return loss_fn(xi, y)

    def grad():
        return torch.autograd.grad(loss_fn(xi, y), xi)

    def fit():
        return map_fit(ll, fwd, icr.zero_xi(), y, steps=EAGER_STEPS,
                       lr=3e-2, **kw)

    flush = torch.empty(512 * 2**20, dtype=torch.float32, device="cuda")
    rec = {"variant": variant, "loss_ms": time_ms(loss, flush),
           "loss_enqueue_ms": enqueue_ms(loss),
           "loss_grad_ms": time_ms(grad, flush),
           "loss_grad_enqueue_ms": enqueue_ms(grad),
           "step_ms": time_ms(fit, flush) / EAGER_STEPS,
           "step_enqueue_ms": enqueue_ms(fit) / EAGER_STEPS}
    # the whole path's host enqueue, as the ``whole_path`` and
    # ``train_step`` lines take it: the apply (S = 8), the transpose op by
    # op and the learned-θ steps, f32
    models, whole = {}, {}
    for cname, (chart, kern) in charts().items():
        icr = ICR(chart, kern, use_pallas=True)
        m = icr.matrices()
        models[cname] = (icr, m, 0.0)
        gen.manual_seed(11)
        xi_s = icr.init_xi(gen, batch=S)
        v = torch.randn((S,) + icr.out_shape, generator=gen, device="cuda")
        whole[cname] = {
            "apply_enqueue_ms": enqueue_ms(
                lambda: icr.apply_sqrt_batch(m, xi_s)),
            "apply_ms": time_ms(lambda: icr.apply_sqrt_batch(m, xi_s),
                                flush),
            "apply_sqrt_T_eager_enqueue_ms": enqueue_ms(
                lambda: icr.apply_sqrt_T_batch(m, v, cached=False))}
    # host ms per call of back-to-back calls (the card keeps up): the
    # apply, and one 1-D forward launch through its wrapper alone
    from repro_torch.kernels import icr_refine

    for cname, (icr, m, _) in models.items():
        gen.manual_seed(11)
        xi_s = icr.init_xi(gen, batch=S)
        whole[cname]["apply_host_ms_per_call"] = host_ms_per_call(
            lambda: icr.apply_sqrt_batch(m, xi_s))
    for name, (f, c, mats) in {"stationary": (2, 3, ()),
                               "charted": (4, 5, (4096,))}.items():
        t = 4096
        ops = [torch.randn(shape, generator=gen, device="cuda") for shape in
               ((S, (t - 1) * (f // 2) + c), (S, t, f), mats + (f, c),
                mats + (f, f))]
        fn = (icr_refine.refine_charted if mats
              else icr_refine.refine_stationary)
        whole[f"wrapper {name} 1-D"] = {
            "host_ms_per_call": host_ms_per_call(lambda: fn(*ops))}
    problems = {k: p for k, p in train_problems(models, gen).items()
                if k in THETA_PATHS}
    for pname, t in train_step_times(problems, flush).items():
        whole[pname + " (learns ρ)"] = {
            k: t[k] for k in ("train_step_ms", "train_step_enqueue_ms",
                              "loss_ms")}
    rec["whole"] = whole
    return rec


def eager_step_ab(specs) -> int:
    """``--eager-step LABEL=SRC[:fpad] ...``: the eager dust fit step of
    each package in turn (list them as parent, change, change, parent to
    see the drift), one process each; prints one ``eager_step`` line per
    run and the card."""
    for spec in specs:
        label, _, rest = spec.partition("=")
        src, _, variant = rest.partition(":")
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--eager-step-one", src, variant or "as-is"],
            capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print("eager_step: " + json.dumps({"label": label, **rec}),
              flush=True)
    print(card_line())
    return 0


def mesh_step_one(src: str, shape: str) -> dict:
    """Phase 11b's sharded gemma3-4b step (bf16, remat, AdamW at a
    constant ``LMS_LR``, phase 10's parameters and batch) on a virtual
    mesh of `shape` ("2x4") slots of the card, with the package under
    `src`: two steps, the second timed by CUDA events with its host
    enqueue; the losses, the peak memory allocated over both and the
    second step's collective counts. The batch as that package's train
    loop hands it over: placed per line where its step gives a batch
    placement (``batch_shardings``), else whole on the card."""
    import dataclasses

    import torch

    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _StepClock
    from repro_torch.optim import constant, optimizers

    cfg = dataclasses.replace(get_arch(LM_ARCH), remat=True)
    mesh = lms_mesh(tuple(int(n) for n in shape.split("x")))
    with lms_optimizer(optimizers.adamw(constant(LMS_LR), weight_decay=0.1),
                       "adamw"):
        ts = make_train_step(cfg, mesh)
    params = ts.model.init_params(
        torch.Generator(device="cuda").manual_seed(0))
    state = ts.opt_sh.place(ts.optimizer.init(params))
    placed = ts.params_sh.place(params)
    del params
    data = SyntheticLMData(cfg.vocab_size, LMT_SEQ, LMT_BATCH, seed=0)
    if hasattr(ts, "batch_shardings"):
        batch = lms_lines_batch(ts, data)
    else:
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in data.batch(0).items()}
    torch.cuda.reset_peak_memory_stats()
    rec = {"src": src, "mesh": shape, "losses": []}
    for _ in range(2):
        clock = _StepClock(torch.device("cuda"))
        clock.start()
        placed, state, metrics = ts.fn(placed, state, batch)
        rec["enqueue_ms"] = clock.enqueued()
        rec["losses"].append(float(metrics["loss"]))
        rec["step_ms"] = clock.elapsed()
    rec["collectives"] = lms_counts(ts.executor)
    rec["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


def mesh_step_ab(specs) -> int:
    """``--mesh-step LABEL=SRC ...``: phase 11b's warm sharded step
    (``mesh_step_one``) of each package in turn, on (2, 4) and then on
    (1, 16), one process each (list them as parent, change, change,
    parent to see the drift); prints one ``mesh_step`` line per run and
    the card."""
    for shape in ("2x4", "1x16"):
        for spec in specs:
            label, _, src = spec.partition("=")
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--mesh-step-one", src, shape],
                capture_output=True, text=True)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                return 1
            rec = json.loads(run.stdout.strip().splitlines()[-1])
            print("mesh_step: " + json.dumps({"label": label, **rec}),
                  flush=True)
    print(card_line())
    return 0


def level0_probe() -> int:
    """``--level0-probe``: can the level-0 root be rebuilt inside a CUDA
    graph? (1) cuSOLVER's syevd through a binding on the current stream
    (``kernels/sym_eig.dense_eigh``: workspace from torch's allocator,
    info on the device) at n = 1024, 2048 and 4096, one process each
    (``--probe-syevd``): eager twice, then captured and replayed, each
    against the first call bit for bit; (2) the root the port takes,
    ``core/refine.level0_sqrt`` (a float64 Cholesky factor), on the three
    learned-θ charts' level-0 points, captured and replayed against its
    eager build bit for bit. One ``probe`` line each, then the card."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import graphs, refine
    from repro_torch.kernels import build

    build.build(["sym_eig", "dense_eigh"])
    roots = {}
    for n in (1024, 2048, 4096):   # one process each: a failed capture
        run = subprocess.run(       # leaves the context unusable
            [sys.executable, str(Path(__file__).resolve()), "--probe-syevd",
             str(n)], capture_output=True, text=True)
        roots[n] = (json.loads(run.stdout.strip().splitlines()[-1])
                    if run.returncode == 0 else
                    {"rc": run.returncode, "stderr": run.stderr[-600:]})
    print("probe syevd: " + json.dumps(roots), flush=True)

    chol = {}
    for cname, rho in (("regular", THETA_PATHS["regular"][1] * 2**20),
                       ("dust", THETA_PATHS["dust_theta"][1]),
                       ("log_polar", THETA_PATHS["log_polar_theta"][1])):
        chart, kern = charts()[cname]
        rho_t = torch.tensor(rho, device="cuda")

        def root(rho_t=rho_t, chart=chart, kern=kern):
            return refine.level0_sqrt(chart, kern({"rho": rho_t,
                                                   "sigma": 1.0}))

        entry = {"points": math.prod(chart.shape(0))}
        try:
            with refine.build_checks():
                first = root()
                replay = graphs.capture(root, device="cuda")
                entry["replay_equal"] = all(torch.equal(replay(), first)
                                            for _ in range(2))
        except Exception as exc:   # the probe records what failed
            entry["error"] = f"{type(exc).__name__}: {exc}"[:600]
        chol[cname] = entry
    print("probe cholesky root: " + json.dumps(chol), flush=True)
    print(card_line())
    return 0


def probe_syevd(n: int) -> int:
    """``--probe-syevd N``: cuSOLVER's syevd (``sym_eig.dense_eigh``) on an
    N-point Matérn matrix, eager twice, then captured in a CUDA graph and
    replayed twice, each against the first call bit for bit; one JSON
    line."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.kernels import kernel_matrix
    from repro_torch.kernels import sym_eig

    x = torch.linspace(0, 1, n, device="cuda")[:, None]
    k = kernel_matrix(charts()["regular"][1].with_defaults(rho=0.05)(), x)
    k = 0.5 * (k + k.T)
    entry = {}
    try:
        first = sym_eig.dense_eigh(k)
        again = sym_eig.dense_eigh(k)
        torch.cuda.synchronize()
        entry.update(workspace_bytes=sym_eig.workspace_bytes(n, "cuda"),
                     eager_repeat_equal=all(torch.equal(a, b) for a, b
                                            in zip(first, again)),
                     info=int(first[2]))
        g = torch.cuda.CUDAGraph()
        buf = k.clone()
        with torch.cuda.graph(g):
            out = sym_eig.dense_eigh(buf)
        for rep in range(2):
            g.replay()
            torch.cuda.synchronize()
            entry[f"replay{rep}_equal"] = all(
                torch.equal(a, b) for a, b in zip(first, out))
    except Exception as exc:   # the probe records what failed
        entry["error"] = f"{type(exc).__name__}: {exc}"[:400]
    print(json.dumps(entry))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe-syevd"]:
        sys.exit(probe_syevd(int(sys.argv[2])))
    if sys.argv[1:2] == ["--level0-probe"]:
        sys.exit(level0_probe())
    if sys.argv[1:2] == ["--kernels-once"]:
        sys.exit(kernels_once())
    if sys.argv[1:2] == ["--eager-step"]:
        sys.exit(eager_step_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--eager-step-one"]:
        print(json.dumps(eager_step_one(*sys.argv[2:4])))
        sys.exit(0)
    if sys.argv[1:2] == ["--tp-peaks"]:
        sys.exit(tp_peaks_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-peaks-one"]:
        print(json.dumps(tp_peaks_one(sys.argv[2])))
        sys.exit(0)
    if sys.argv[1:2] == ["--mesh-step"]:
        sys.exit(mesh_step_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-step-one"]:
        print(json.dumps(mesh_step_one(*sys.argv[2:4])))
        sys.exit(0)
    sys.exit(main())
