#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (firedancer_tpu_torch) on one Hopper
card: the quickest proof that the port builds, verifies and signs on the
GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. Card: print the card's name and power limit (nvidia-smi) and its
   compute capability; require CUDA with capability 9.x.
2. Build: the ring library build/libfdtango.so (make -C native) on a
   thread beside nvcc, which compiles every kernel from
   firedancer_tpu_torch/ops/csrc into build/torch_kernels/; print the
   seconds and ptxas's registers and spills, K3's window loop, the decompress core's
   squaring loop (in K2 and in compress) and the SHA-512 core's round
   loop in SASS (instructions
   a thread an iteration and their opcode mix, from cuobjdump); the
   scalar kernels' whole functions, and the shared Barrett sc_reduce512
   and mul256 alone in a probe built against sha512.cuh.
3. Kernel parity: each of the fifteen kernels of the verify and signing
   paths (pack_schedule in phase 8, dedup_filter in phase 9) against
   its plain PyTorch version on the same CUDA tensors, at the main
   paths' shapes; they must agree exactly (canonical bytes, limbs and
   masks). The fd_drain's dedup_filter (dedup_filter.cu: one launch of
   one CTA whose shared memory holds a hash table of lane indices and
   the window, up to 2,048 lanes; past them, or for a wider window, a
   memset and two launches over a grid) runs at the start of phase 9,
   on the meta sigs of its corpus: against dedup_filter_ref, novel mask,
   new bank A and count equal and both input banks unchanged, on the
   corpus's tags, on the same with in-batch repeats, invalid lanes, the
   all-ones tag before and after an invalid lane, forced bucket
   collisions and random banks planted, and with an invalid prefix, at
   n = 1, 31, 33, 1200, 2048, 2049, 8191 and 65536 and windows of 2^10,
   2^17 and 2^20 bits, at 131072 lanes and 2^17 bits and at 1200 lanes
   and 2^23 bits, then over 16 chained rounds of 8192 lanes and of
   their first 1200 with a rotation halfway; a window of 3 words must
   be refused before any launch; timed by CUDA events and the trace
   (after a discarded warm-up step, each recorded step padded by 20 ms
   of idle host time on either side; a trace holding 90 % of the
   launches must show one device operation a call on the one block and
   four on the grid, or the run fails; a trace that loses launches in
   every try is reported as not measured) at the main path's 1200 staged
   lanes, n = 1, 8192 lanes, 65536 and 2^20 bits, both launches at 2048
   and 4096 lanes, and the parent's launch on the main path, with each
   shape's geometry and ptxas's registers (0 stack and 0 spills). The
   bucket fill and
   aggregation split a lane's slots and a column's buckets over a warp:
   their plain versions are the split mirrors (*_split_ref), and each
   launch must also give the same points as the JAX-order version
   (cross-multiplied on every lane, affine bytes on 512). The RLC front
   half's three: frontend_rlc and sha512_batch on 8192 hash rows (and on rows
   of every length 0-1296; sha512_batch also on signing's 32-, 224- and
   1344-byte rows, the last of the 1280-byte bucket), decompress_niels on
   2 x 8192 encodings with
   y = +-1, non-square, non-canonical and small-order lanes planted, its
   points equal to K2's. K1, frontend_rlc and sha512_batch (one
   warp-staged SHA-512 core, 32 lanes a warp) also run on rows of stride
   1299, on 256-byte rows at an odd base address and (frontend_rlc) with
   z and s at odd addresses, each shape at B and at n = 1, 31, 33 and
   8191 lanes; ptxas must report 0 bytes of stack and 0 spills for the
   three; each prints the trace's device time beside its CUDA-event time
   (their wrappers' host path is longer than the kernels;
   firedancer_tpu_torch/tools/hash_times.py times them by shape and warps
   a block), as do point_eq, sc_reduce64, sc_muladd, fe_pow and compress.
   point_eq (the same five-thread group) on six kinds of lanes (equal
   at Z = 1 and Z != 1, only X or only Y differing, every limb in
   [2^51 - 19, 2^52), another lane's point) at the n of fe_pow, with aff
   of 2 and 4 and proj of 3 and 4 coordinates, byte for byte, timed by
   the trace at n = 1, 8192 and 2 x 8192, with 0 stack and 0 spills.
   Both decompress kernels (one core, five threads
   a lane, six lanes a warp) also run at n = 1, 5, 6, 7, 31 and
   2 x 8192 - 3 lanes; K2 is
   timed at 8192, 2 x 8192 and 4 x 8192 lanes, and both print their
   registers, stack and spills. The four MSM
   kernels take their inputs staged from a clean 8192-lane batch through
   the RLC front half: the three bucket fills (z, 253-bit, torsion) on
   the decompress kernel's niels forms, the three aggregations, both
   Horners (also at nw = 1, 2 and 130) and the K = 64 [L] ladder (also on
   planted edges at K = 1, 7, 9 and 64 and on the torsion batch (t)'s
   trial aggregates), each alone, then the three chains in the one
   msm_tails launch the pass makes, all limb for limb; then, at every
   plan of msm_plan.all_plans(), both MSMs' fills (signed plans with the
   sign folded into the gather), aggregations, Horners and the tails
   launch, and the pass's verdict. Each fill, aggregation, Horner and
   ladder prints its thread mapping or its longest dependent chain
   before and after, and each fill is also timed at C = 4, 8, 16 and 32
   threads a lane, and each aggregation right after its fill, as the
   pass runs it; the tails kernel prints its resources. The
   signing path's four: sc_reduce64 on 8192 64-byte values with the edges
   0, L - 1, L, 2^255 - 1 and 2^512 - 1 planted; sc_muladd with c != 0
   (signing's h a + r, a clamped) and c = 0 (the staged pass's stacked
   z || z times h || s); both scalar kernels (blocks of 64 lanes staged
   through shared memory) also at n = 1, 31, 33, 8192 - 3, 8192 and
   2 x 8192, with every input a view at byte offset 0, 8 and 1 (16-byte,
   8-byte and byte staging) and the edges planted, byte for byte, each
   timed by the trace at n = 1, 8192 and 2 x 8192, with 0 stack and 0
   spills; fe_pow, both chains on the decompress core's five threads a
   lane, on 8192 lanes and at n = 1, 5, 6, 7, 31, 128, 8192 - 3, 8192
   and 2 x 8192 with z = 0, 1, p - 1, values in [p, 2^255), limbs in
   [2^51, 2^52) and every limb 2^52 - 1 planted, limb for limb, timed by
   the trace at n = 1, 128, 8192 and 2 x 8192, with 0 stack and 0
   spills; compress (the
   decompress core's five threads a lane, through its inversion chain) on
   K3's outputs with the edge points planted (the identity, the torsion
   points and y within 19 of p, at Z = 1 and Z != 1; Z = 0 lanes; the
   same points with every limb in [2^51, 2^52)), also at n = 1, 5, 6, 7,
   31 and 8192 - 3 and on (n, 4, 5) points, byte for byte, with 0 stack
   and 0 spills; and K3 itself with
   h = 0 and clamped scalars, as signing calls it. K3 (a quad of threads
   a lane) must equal double_scalarmult_ref limb for limb on every
   launch: the general one, the two h = 0 ones and an edge launch (h, s
   of 0, 1, 15, 2^256 - 1 and alternating 0/15 nibbles on the torsion
   points and the base point, at Z = 1 and Z != 1) at n = 1, 31, 33 and
   8191 lanes, the ragged tails of its 32-lane block; 16 edge lanes also
   against the oracle. K3's registers, stack, shared memory a block and
   blocks an SM are printed from the CUDA runtime. Times with CUDA
   events, warm, the kernel's mean over 20 launches beside the plain
   version's, summed over the launches of one pass (one signing call for
   the signing kernels).
4. Direct path: registry().acquire(EngineSpec("direct", 8192)) answers
   three 8192-lane batches (bench traffic; the same with salted,
   s >= L, undecodable-key lanes and the 396 Zcash vectors; MTU-sized
   messages). Statuses must equal the constructed ones and the plain
   path's on the card; every kernel's launch count must advance and every
   plain count stay 0. Then verifies/s over 10 timed batches, and the
   device time by kernel over 3 batches (torch.profiler).
5. RLC path, in both front halves: registry().acquire(EngineSpec("rlc",
   8192, frontend=f)) for f = "fused" and "staged" answers (a) the bench
   batch (batch_ok True, no fallback, every status 0; decompress_niels
   launches once, frontend_rlc (fused) or sha512_batch (staged) once,
   the fill and aggregation kernels 3 times each, the tails kernel
   (both Horners and the ladders) once, and no direct-path kernel), (b) the
   mixed batch and (t) a torsion batch (an order-2 pair and four
   order-8-offset lanes): both fall back, with the direct path's
   statuses. Then verifies/s on (a), the cost of (b), the device time by
   kernel (torch.profiler) and the host clock of the pass's stages. The
   staged pass launches sha512_batch, sc_reduce64 and sc_muladd once
   each and no plain version.
6. Signing path: disco.corpus.sign_jobs at two shapes, B = 8192 with
   192-byte messages and B = 4096 with 100-1232-byte messages (rows of
   the 1280-byte bucket). Each signing call must launch sha512_batch 3,
   sc_reduce64 2, double_scalarmult 2, compress 2 and sc_muladd 1 times
   and no plain version; its bytes must equal the plain composition's on
   the same CUDA tensors and the oracle's on 64 lanes; the signed batch
   must verify through EngineSpec("direct") (every status 0) and
   EngineSpec("rlc") (batch_ok True, no fallback). Then signatures/s by
   CUDA events and by the host clock, and the device time by kernel.
7. Verify tile: the port's mainnet_corpus(n=32768, seed=42) built and
   signed on the card, the 67 mainnet fixtures (tests/fixtures/
   transaction*.bin, txn_pack/*.bin) at its front; replay -> verify ->
   sink threads on build_topology(depth=32768) rings, the sink reading
   verify_dedup, VerifyTile(backend="gpu", batch=8192, inflight=2,
   tcache_depth=4096) in four runs: (1) direct, native drain; (2) rlc
   fused, native drain; (3) direct, frag by frag in Python; (4) rlc
   fused on the corpus built with no duplicate, corrupt or truncated
   traffic. Each run must account exactly (the sink's distinct digests
   are the valid set, no BAD_SIG or BAD_PARSE payload reaches it,
   SV_FILT_CNT = #BAD_SIG + #BAD_PARSE, HA_FILT_CNT plus the duplicates
   at the sink = #DUP, the fixtures publish as the oracle's statuses
   say), launch each kernel batches x its launches a batch (plus the
   direct rows once a fallback), run no plain version, and give each
   batch the verdict its fill allows (a full flush holds at least
   B - MAX_SIG_CNT + 1 lanes, every other flush fewer than B); run (4)
   must not fall back. Prints each run's txn/s and signature lanes/s
   (host clock, first publish to last sink frag), the p50/p99 latency
   from each txn's publish to its sink frag on the full 64-bit tick
   count, batches, fill ratio, flush verdicts, fallbacks and the
   device's busy share (torch.profiler).
8. Pack: (a) pack_gc.cu's pack_schedule (the graph coloring of
   ops/pack_gc.py; a compaction launch, then the scan on one warp, the
   per-bucket color masks in 64 KB of dynamic shared memory at H = 4096)
   against pack_schedule_ref on the same CUDA
   tensors, lane for lane, on seven blocks (the mainnet mix of phase 7's
   dirty corpus and the fixtures as the pack tile sees them,
   conflict-heavy, wide rows of 30-70 valid and partly repeating
   buckets, disjoint, capped by CUs, equal scores, padding) at
   n = 1, 31, 1024, 2048, 4096 and 8192 (the N of phase 9's drain_pack
   colorings), with C = 64 colors, H = 4096 buckets,
   35 + 35 bucket columns; the conflict-heavy and wide blocks also at
   n = 1024 with C = 100, 150, 300 and 1000 (2, 3, 5 and 16 mask words a
   bucket set); and on bench.py pack_worker's block (65,536 txns over
   16,384 accounts, seed 7, H = 8192) at n = 16384; times of the mainnet
   block at 1024, 2048 and 8192, the padding block at 1024 and the bench
   block at 65,536 (its waves validated): CUDA events, the trace's
   device time of both launches, ns a step, the chain's floor (one
   warp's step skeleton), the plain version. (b) run_pipeline(feed=False) on the
   card (the in-process step loop), replay -> verify (direct, B = 8192)
   -> dedup -> pack -> sink on phase 7's dirty
   corpus and the fixtures (depth 32768, a dedup window of 2^18 that
   spans the corpus, as bench.py's replay gate sets it), with
   pack_scheduler "greedy", then "gc". Each run must deliver exactly the
   valid txns (the sink's digest multiset), count every other txn in a
   filter (HA + SV + the dedup and pack links' filters = DUP + BAD_SIG +
   BAD_PARSE + the fixtures the oracle rejects), reach more than one
   bank, launch each direct kernel once a verify batch and, on gc,
   pack_schedule once a block, with device-accepted blocks + fallbacks =
   blocks, and run no plain version. Prints txn/s (host clock), p50/p99
   latency from publish to sink, each link's publish count, the filters,
   thread CPU by tile, the device's busy share and, on gc, blocks,
   accepted schedules and fallbacks.
9. Feed: run_pipeline through the fd_feed runtime (its default), with
   phase 8 (b)'s checks and res.feed true, no fallback reason, no
   leaked slot, and the process layout asked for. Every run arms the
   fd_drain, the feed's default, unless
   it says drain="off": each batch filtered once (dedup_filter launches
   = drain batches = batches), the novel and maybe publishes equal to
   verify's publishes and to the dedup tile's skipped and made probes,
   no false novel; a drain-off run filters nothing. Every run takes the
   verify tile's automatic rotation quota, drain.rot_quota of the run's
   TCache, ring and batch. (a) The bench's replay gate (bench.py:287-315):
   mainnet_corpus(n=100000, seed=1234) built and signed on the card,
   rings 4,096 deep in a 2^27-byte workspace, B = 8192, a dedup window
   of 2^18, inflight 4, a 200 ms deadline, direct, greedy, the source
   and dedup/pack/sink in worker processes, twice: drain on, then off
   (the A/B, cut from four runs in turns to keep the script within half
   its time limit, with its txn/s and latencies side by
   side). (r) The window's rotation at run_pipeline's default TCache of
   4,096 (quota 4,096 + 4,096 + 8,192): 48,000 of (a)'s valid txns, each
   followed by a copy with a corrupted signature, and a repeat every 50
   valid txns, alternately near (the HA filter drops it) and 2,129 to
   3,481 valid txns back (past the HA TCache, inside the dedup
   TCache), each txn repeated once at most, in worker processes: the
   HA and dedup filters must drop exactly the planted repeats, the
   window rotate at least once, and no claim be false. (b) Phase 8
   (b)'s traffic in five runs: greedy direct in
   process, greedy direct in worker processes, gc direct (in process:
   the gc pack always is), greedy rlc (fused) in worker processes, and
   gc direct with drain_pack: each verify batch colored by
   pack_schedule at N = 8192 behind its filter, the colors carried in
   the ctl word to the pack's device blocks (pack_schedule launches =
   verify batches + the blocks the pack colors itself, no block falling
   back to the greedy waves; the first and the last batch's colors,
   pad rows included, held lane for lane to pack_schedule_ref on the
   same CUDA tensors). Each run also prints the six stage
   latencies from the replay's publish, slot stalls, the device's idle
   estimate, CPU seconds by process (the main process, and the workers'
   after they exit) and the host's cores. The kernel rows' launches in
   the JSON line are those of the phase-9 run that runs them: (a)'s
   first drain-on run for the direct rows and dedup_filter, the gc run
   for pack_schedule, the rlc run for the RLC rows. Then the engine
   ladder: K1-K4 at 16,384 and 32,768 and dedup_filter on the staged
   txns of a 32,768-lane batch against their plain versions
   (rung_kernel_parity); (l) (a)'s corpus and options at B = 32,768 on
   rings 32,768 deep with the default ladder 8,192 / 16,384 / 32,768,
   scheduler on, then off (the A/B), beside (a)'s figures: every batch
   in rung_hist, at least two rungs used, every rung WARM and each used
   rung with a service EMA, launches = the batches' plus those of the
   warm passes the run made; (k) the same run with a ReconfigController
   on a request file: to rlc on the ladder [16,384] once a batch has
   shipped, back to direct with the drain off once that applied, a
   third request refused while the second pends; two reconfigs, one
   refusal, the sink exact, the retired engines gone from the registry.
10. App: the operator entry point, driven in process as a user runs it
   (fdctl.main / fddev.main) from a TOML written to a scratch directory
   under build/: rings 4,096 deep in a 2^26-byte workspace, the gpu
   backend at B = 8192, a dedup window of 2^17 that spans the load, and
   [development.synth]'s load of 32,768 txns with 10 % repeats and 10 %
   corrupt signatures (39,320 payloads), signed on the card. (a) fddev
   dev on one lane (configure init all, run, fini: the feed with the
   fd_drain armed); (b) fdctl configure init all, run and monitor --once
   on two verify lanes (the replay round-robin over replay_verify and
   replay_verify.v1, the dedup tile muxing both lanes back in: the
   in-process step loop, the feed's lane reason recorded); (c) fdctl
   run --source pcap on one lane, a pcap written by the port's
   PcapWriter from the first 8,192 synth payloads. Each run: the
   distinct valid txns reach the sink, sent - recv_cnt = the HA and SV
   filters of every lane + the dedup links' + the pack link's, every
   lane's replay_verify carried traffic, each lane ran batches and K1-K4
   launched once a batch in the run (dedup_filter once a batch in the
   feed runs), no warm pass and no plain version in the run; the synth's
   signing launched keygen_batch once and sign_batch once a 4,096 jobs.
   Prints txn/s (host clock), the feed's stage latencies, seconds and
   launches by kernel.
   Every pipeline run of phases 7 to 10 also fails unless each verify
   tile's cpu_failover, quarantined, breaker_trips and stager_restarts
   are 0: outside phase 11 no fault is injected, so a kernel fault that
   the breaker or the quarantine would absorb fails the run instead.
   fd_flight and fd_sentinel run in every pipeline run, on by default;
   each run of phases 8, 9 and 12 (pipeline_run; a feed run through
   run_feed_pipeline, run_pipeline's route, with a hook that keeps the
   verify tile) also fails unless each link's span counts every frag
   published on it and the sink's every receipt, verify_stats equals
   the registry's verify row and the tile's own batch log, slot pool
   and breaker field for field, and the sentinel polled at least once a
   second of the run; (a)'s runs also write their Prometheus text,
   which must parse and carry the verify row. Each run prints its spans
   (n, p50 and p99 bucket bounds by edge) and the sentinel's polls and
   alerts.
11. Chaos: the verify tile's healing lane on the card. First the CPU
   lane (ballet.ed25519.native.verify_arrays, the native C++ verifier)
   against K1-K4's statuses on phase 4's batch (b), lane for lane (every
   bad status and the 396 Zcash vectors), with its lanes/s. Then
   scripts/chaos_smoke.py's corpus mix at the tile's size
   (mainnet_corpus(n=32768, seed=4242, dup 5 %, corrupt 3 %, parse
   errors 2 %, data up to 140 bytes), signed on the card) through
   run_feed_pipeline on rings 4,096 deep, B = 8192, a TCache of 2^17,
   inflight 4, the drain armed, in process, with the injector armed at
   seed 42 and that script's seven-class schedule (ring_ctl_err@7,
   ring_ctl_err@60, ring_overrun@9, credit_starve@100:160, stager_kill@5,
   slot_corrupt@4, backend_raise@3, device_lost@1:3) and a breaker of
   threshold 2 and 20 ms: verify mode direct, then rlc (fused). Each run
   must deliver expected_sink_digests less exactly one corrupted txn,
   give every class injected = detected = healed >= 1, leak no slot,
   restart the stager once, trip and re-probe the breaker and end it
   closed, fail over and quarantine at least once, drop at least two
   CTL_ERR frags, overrun replay_verify at least once, filter at least
   the quarantine's CTL_ERR frags on verify_dedup, fall back at least
   once in rlc, and launch exactly: the verify rows once a batch that
   reached the card (batches less those the CPU lane served), the direct
   rows once more an rlc fallback, dedup_filter once a batch (failover
   batches included), no warm pass and no plain version. Prints each
   run's txn/s and the CPU lane's lanes/s over the batches it served.
   Last, the trace's padding A/B at the end of the run (five traces of
   the filter's 2,048-lane block unpadded and five padded, in turns; as
   at phase 9's start).
12. Flight: first the registry's host cost a call (a span observe, a
   1,200-frag bulk observe, a lane increment and publish, a sentinel
   poll); then (f) cut to the first 30,000 payloads of phase 9's corpus
   (relabelled: a txn's first copy in the cut is the valid one), rings
   4,096 deep, B = 8192, inflight 4, the drain on, worker processes,
   four runs in turns with fd_flight and fd_sentinel off, on, on, off,
   each with phase 9's checks. Each run is read while it runs by
   firedancer_tpu_torch/tools/fd_top.py (a process of its own, a frame
   every 0.5 s) and monitor.snapshot (a thread, every 0.5 s): in an
   "on" run both must show the sink's span mid-run and the SLO rows
   polled, fd_top its SPAN and SLO panels, and fd_top's --prom (its
   main called here) on the final rows the run's own Prometheus text
   (compile records aside);
   an "on" run writes a HALT dump and the two workers' dumps into a
   temporary directory, which must parse and hold the verify row, the
   sink's span, the polled SLO rows and the verify recorder's dispatch
   and halt events; an "off" run must record no span and run no
   sentinel. Prints each run's txn/s and p50/p99, the means on and off
   and the phase's seconds, beside the card's name and power limit.
13. Xray: fd_xray on the card. (x): phase 12's 30,000 payloads on
   rings 32,768 deep (every link's ring keeps the meta of each frag it
   carried), B = 8192, inflight 4, the drain on, worker processes,
   flight and the sentinel on (the end-to-end budget at 1 ms over
   windows of 0.5 and 1 s, so it alerts), four runs in turns with xray
   off, on, on, off, each with phase 9's checks and read live by fd_top
   and monitor.snapshot. An "on" run (autopsies into a temporary
   directory) must give each link's head count equal to sampled_mask
   over the trace ids read back from its mcache and the sink's over the
   pack's, every full span chain at the sink non-decreasing in latency,
   a dwell on every link, a waterfall that reconciles with stage_hist, a
   HALT autopsy and at least one alert autopsy that parse,
   tools/fd_xray.py --chrome-trace over the HALT autopsy with an event a
   span, fd_top's XRAY panel mid-run and PipelineResult.xray's JAX keys;
   an "off" run no summary, no autopsy and no queue row. Then one (l)
   run (B = 32,768, rings 32,768 deep, the scheduler on, xray on):
   prints the verify -> dedup edge's credit stall (ns, count), the
   verify tile's tile_heartbeat alerts and the autopsies' first
   suspects. Prints each run's txn/s and p50/p99, the means on and off,
   the launches and the phase's seconds, beside the card's name and
   power limit.
14. Soak: scripts/soak_smoke.py on the card through disco.soak.run_soak.
   The plan build_plan(seed=23, n_phases=4, phase_s=10, rate=450) (the
   drift rotation arms hb_stall in phase 1 and credit_starve in phase 3)
   signed on the card; the verify tile at B = 8192, verify mode direct,
   the drain on, the pack greedy, the sentinel's compressed budgets and
   the probe every 250 ms. The soak half arms the plan's chaos (every
   tile in process) and sends this process SIGHUP, which makes a
   ReconfigController apply {"verify_mode": "rlc", "frontend": "fused"}
   at 15 s, mid phase 1 (both engines warm before); the control half
   runs the same payloads with neither, in the feed's default layout. Each must log 4 phases,
   drop and leak nothing, arm its slopes within budget, be judged ok and
   pass tools/bench_log_check.validate_soak; the soak half books no
   unexplained alert, hb_stall and credit_starve injected = detected =
   healed >= 1, one reconfig applied and none refused, the batches after
   the swap on the rlc engine, and a sink digest multiset equal to the
   control's, which books no alert; launches exact (the direct rows once
   a direct batch and once an rlc fallback, the fused pass once an rlc
   batch, dedup_filter once a batch, no warm, no plain version) and no
   healing counter. Prints the plan, each phase's offered and published
   rate, each half's txn/s and p50/p99, the slopes, ring_hwm, each
   tile's housekeeping passes, the traced heap's largest growth by line,
   the device memory before and after each half, the launches and the
   phase's seconds, beside the card's name and power limit; the records
   go to build/soak/.
15. Output: the card line, one JSON line of per-kernel numbers, and the
   last line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 8192                 # FD_BENCH_BATCH
MSG_LEN = 192            # FD_BENCH_MSG_LEN
MTU_MSG = 1232
REPS = 20
# Host wall time a trace's recorded step keeps idle before its first
# launch and after its last (traced_call_ms): the profiler keeps a
# device activity only if its timestamps, mapped to the host clock, fall
# inside the step's window, and a step of 20 launches of a few
# microseconds is far shorter than the mapping's error.
TRACE_PAD_S = 0.02
TIMED_BATCHES = 10
DIRECT_KERNELS = ("sha512_mod_l", "decompress_so", "double_scalarmult",
                  "point_eq")
# The front half's launches in one clean RLC pass, by front half.
FRONT_LAUNCHES = {"fused": {"frontend_rlc": 1},
                  "staged": {"sha512_batch": 1, "sc_reduce64": 1,
                             "sc_muladd": 1}}
# Launches of one signing call (ops/sign.py sign_batch).
SIGN_LAUNCHES = {"sha512_batch": 3, "sc_reduce64": 2, "double_scalarmult": 2,
                 "compress": 2, "sc_muladd": 1}
SIGN_SHAPES = ((8192, "192-byte messages"), (4096, "100-1232-byte messages"))
# Launches of one clean RLC pass, by front half.
RLC_PASS = {"decompress_niels": 1, "msm_fill": 3, "msm_aggregate": 3,
            "msm_tails": 1}
# The kernel rows that run inside the pass's one msm_tails launch.
TAILS_ROWS = ("msm_horner", "msm_order")
# Threads a lane at which phase 3 times each bucket fill.
FILL_SWEEP = (4, 8, 16, 32)
# Ragged batches of the decompress kernels (six lanes a warp, 24 a block).
RAGGED = (1, 5, 6, 7, 31)
# Ragged batches of the warp-staged hash kernels (32 lanes a warp).
HASH_RAGGED = (1, 31, 33, B - 1)
# Lanes and byte offsets of phase 3's scalar-kernel launches (blocks of
# SC_THREADS lanes; a base 16-, 8-byte or 1-byte aligned picks the
# staging's access width), and the lanes it times them at by the trace.
SC_RAGGED = (1, 31, 33, B - 3, B, 2 * B)
SC_OFFSETS = (0, 8, 1)
SC_TIMED = (1, B, 2 * B)
# Lane counts of fe_pow and point_eq on the five-thread group (six lanes a
# warp, 24 a block), and those each is timed at: n = 1 is the launch's
# fixed cost, 128 the JAX package's root inversion at B (B / 64 lanes).
GROUP_RAGGED = (1, 5, 6, 7, 31, 128, B - 3, B, 2 * B)
POW_TIMED = (1, 128, B, 2 * B)
EQ_TIMED = (1, B, 2 * B)
# The tile phase: a mainnet-mix corpus of TILE_N unique transactions
# (signed in batches of TILE_SIGN_B), rings TILE_DEPTH deep (a full batch
# holds ~6,800 txns, and inflight 2 plus one filling ~20,500 unacked) in
# a workspace of TILE_WKSP bytes for the four links' ~42 MB dcaches.
TILE_N = 32768
TILE_SIGN_B = 4096
TILE_DEPTH = 32768
TILE_WKSP = 1 << 28
# The pack phase: pack_schedule's blocks (lanes) and the tile's
# parameters (ops/pack_gc.py: C colors, H buckets, the CU cap a wave;
# ballet/txn.py MAX_ACCT_CNT bucket columns each of writes and reads).
PACK_N = (1, 31, 1024, 2048, 4096, B)
PACK_TIMED = (1024, 2048, B)
PACK_C, PACK_H, PACK_CAP, PACK_A = 64, 4096, 12_000_000, 35
# Colors past one 64-bit mask word, with the H whose masks fit shared
# memory: K = 2, 3, 5 and 16 words (the scan's KT = 2, 4, 8 and 16
# instantiations), held to the plain version on PACK_K_N rows.
PACK_K = ((100, PACK_H), (150, PACK_H), (300, 1024), (1000, 256))
PACK_K_N = 1024
# bench.py pack_worker's block (bench.py:341-350): txns, accounts, the
# seed, its h_bits; held to the plain version on its first PACK_BENCH_EQ.
PACK_BENCH_N, PACK_BENCH_ACCTS, PACK_BENCH_SEED = 65_536, 16_384, 7
PACK_BENCH_H, PACK_BENCH_EQ = 8192, 16_384
# The pipeline runs' dedup window (the verify tile's HA filter and the
# dedup tile): it must span the corpus for the sink to get each valid
# txn once, as the JAX bench's replay gate sets it (bench.py:309); at
# 4096 a duplicate more than 4096 unique txns after its original passes.
PIPE_TCACHE = 1 << 18
# The feed phase (a): the bench's replay gate (bench.py:287-315,
# FD_BENCH_REPLAY_N and its corpus seed; rings, workspace and verify
# options as it passes them, the verify mode pinned).
FEED_N = 100_000
FEED_SEED = 1234
FEED_DEPTH = 4096
FEED_WKSP = 1 << 27
FEED_OPTS = {"inflight": 4, "max_wait_us": 200_000, "verify_mode": "direct"}
# The fd_drain pre-filter (row 17): its parity shapes (lanes, window
# bits) and the chained rounds at B with one rotation halfway. Phase 9's
# runs take the verify tile's automatic rotation quota (drain.rot_quota
# of their TCache, ring and batch), which no run of PIPE_TCACHE reaches.
# The one block serves up to dedup_filter_cuda.ONE_CTA_LANES = 2048 lanes
# (and windows up to 2^19 bits), the grid the rest.
DRAIN_N = (1, 31, 33, 1200, 2048, 2049, B - 1, 65536)
DRAIN_H = (1 << 10, 1 << 17, 1 << 20)
DRAIN_ROUNDS = 16
# The grid's widest parity shapes: lanes past what any earlier launch
# took, and a window of 2^23 bits behind a feed batch's staged txns.
DRAIN_WIDE = ((131072, 1 << 17), (1200, 1 << 23))
# The staged txns of a feed batch of B in phase 9 (f), which fills
# 0.13-0.15 of its lanes (PERF.md section 5): the lanes the tile's filter
# takes on the main path.
DRAIN_MAIN = 1200
ALL_ONES = (1 << 64) - 1
# Phase 9 (r): run_pipeline's default TCache (4096), whose automatic
# quota (4096 + FEED_DEPTH + B = 16,384 confirmed-novel publishes) the
# run's ROT_UNIQUE valid txns pass twice or so; a repeat every
# ROT_EVERY valid txns.
ROT_TCACHE = 4096
ROT_UNIQUE = 48_000
ROT_EVERY = 50
# Phase 9 (l) and (k): the engine ladder at full width. A staging batch
# of LADDER_B tops the default ladder (engine.DEFAULT_LADDER); (a)'s
# corpus, dedup window, inflight and deadline, with rings TILE_DEPTH
# deep: at (a)'s 4,096 the held-back ack commits every slot by 4,032
# txns (about 4,400 lanes), so no batch could pass the smallest rung.
LADDER_B = 32768
LADDER_RUNGS = [8192, 16384, 32768]
# K1-K4 at the rungs above the main path's B (row 17 at a LADDER_B-lane
# batch's staged txns).
RUNG_B = (16384, 32768)
# (k)'s live reconfig requests, written to the controller's file in
# turn; the third is made as soon as the second is accepted, while it is
# pending, and must be refused.
# (k) takes the first RECONFIG_N payloads of (a)'s corpus, enough for
# its two swaps, to keep the script within half its time limit.
RECONFIG_N = 60_000
RECONFIG_1 = {"verify_mode": "rlc", "frontend": "fused", "ladder": [16384]}
RECONFIG_2 = {"verify_mode": "direct", "drain": "off"}
RECONFIG_3 = {"ladder": [8192]}

# The app phase (10): [development.synth]'s load, rings and window.
APP_TXN = 32768
APP_FRAC = 0.1
APP_DEPTH = 4096
APP_WKSP = 1 << 26
APP_TCACHE = 1 << 17
APP_PCAP_N = 8192
APP_SIGN_B = 4096          # disco.corpus.sign_jobs' batch
# Launches of one keygen_batch call (the synth's public keys).
KEYGEN_LAUNCHES = {"sha512_batch": 1, "double_scalarmult": 1, "compress": 1}

# The chaos phase (11): scripts/chaos_smoke.py's corpus mix (:48-49,
# :81-84) at the tile's size, its injector seed, schedule (:55-58, seven
# fault classes) and breaker (threshold 2, 20 ms), on rings 4,096 deep,
# a TCache of 2^17, inflight 4, the drain armed, the feed in process.
CHAOS_N = 32768
CHAOS_CORPUS_SEED = 4242
CHAOS_SEED = 42
CHAOS_SCHEDULE = ("ring_ctl_err@7,ring_ctl_err@60,ring_overrun@9,"
                  "credit_starve@100:160,stager_kill@5,slot_corrupt@4,"
                  "backend_raise@3,device_lost@1:3")
CHAOS_CLASSES = ("ring_ctl_err", "ring_overrun", "credit_starve",
                 "stager_kill", "slot_corrupt", "backend_raise",
                 "device_lost")
CHAOS_DEPTH = 4096
CHAOS_TCACHE = 1 << 17
# The flight phase (12): (f) cut to its first FLIGHT_N payloads, four
# runs in turns, flight and sentinel off and on, each read live every
# PROBE_S seconds.
FLIGHT_N = 30_000
FLIGHT_ARMS = (False, True, True, False)
PROBE_S = 0.5
# Phase 13 (fd_xray): (x) is (f)'s first XRAY_N payloads on rings
# XRAY_DEPTH deep, so every link's ring still holds the meta of each frag
# it carried (the trace ids the head counts are held to), xray off, on,
# on, off; every run's sentinel judges the end-to-end budget at 1 ms
# over windows of 0.5 and 1 s, so it alerts within a run of a few
# seconds. The default sampling (1 in 64) and ring (512 spans).
XRAY_N = 30_000
XRAY_ARMS = (False, True, True, False)
XRAY_DEPTH = 32768
XRAY_SENTINEL = {"budgets": {"FD_SLO_E2E_BUDGET_MS": 1}, "fast_s": 0.5,
                 "slow_s": 1.0}
XRAY_LINKS = ("replay_verify", "verify_dedup", "dedup_pack", "pack_sink")
# PipelineResult.xray's keys, the JAX package's.
XRAY_KEYS = ["exemplars", "sample_rate", "suspects", "top_slowest",
             "traces", "waterfall"]
CHAOS_OPTS = {"inflight": 4, "breaker_threshold": 2,
              "breaker_cooldown_ms": 20}
# Phase 14 (fd_soak): scripts/soak_smoke.py's seed and compressed
# window over four phases, so the drift rotation arms both its window
# classes. The base rate stays well under 2,000 txn/s: the traced heap
# grows by about 340 B a txn on this path (the sink's digest ledger and
# the two 65,536-deep TCaches filling), so 2,000 would read as a leak
# of about 45 MiB a minute against the 16 MiB budget, and the traced
# in-process soak half does not drain it within its timeout. 10 s
# phases keep about 23,000 payloads, past credit_starve's window of
# source attempts 15,200-17,200; the swap lands mid phase 1, as the
# JAX smoke's at 7 s of 6 s phases.
SOAK_SEED = 23
SOAK_PHASES = 4
SOAK_PHASE_S = 10.0
SOAK_RATE = 450.0
SOAK_SWAP_AT_S = 1.5 * SOAK_PHASE_S
# Each half's timeout: the in-process soak half may fall behind its pace
# (tracemalloc traces every allocation of five Python tiles; on an H100
# host it took 60-90 s for its 40 s script within a full smoke run, and
# kept pace when run alone), which is not a failure.
SOAK_TIMEOUT_S = 300.0
SOAK_REQUEST = {"verify_mode": "rlc", "frontend": "fused"}
SOAK_PROBE_MS = 250
SOAK_SENTINEL = {"budgets": {
    "FD_SLO_E2E_BUDGET_MS": 900000, "FD_SLO_SOURCE_BUDGET_MS": 900000,
    "FD_SLO_QUIC_INGEST_MS": 900000, "FD_SLO_HEAP_SLOPE_KB": 16384,
    "FD_SLO_POOL_SLOPE_MILLI": 200000, "FD_SLO_COMPILE_SLOPE": 36000,
    "FD_SLO_STALL_MS": 300000, "FD_SLO_HB_MS": 120000}}
SOAK_CLASSES = ("hb_stall", "credit_starve")

# Peak rates of an H100 SXM at its 700 W limit (NVIDIA's data sheet):
# 3.35 TB/s of HBM; 67 TFLOP/s fp32 = 33.5 T FMA/s, and the
# 32-bit integer multiply-add (IMAD) and integer ALU pipes issue at half
# the fp32 FMA rate (64 vs 128 per SM per clock on compute capability
# 9.0, CUDA C++ Programming Guide throughput table).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 33.5e12 / 2
# A 64x64->128-bit product costs at least four 32x32->64 IMAD.WIDE.
IMAD_PER_MUL, IMAD_PER_SQ = 25 * 4, 15 * 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- bounds
# Least time of each kernel's work on this card, from the operations its
# inputs need (counted from the kernel source) and the bytes it must move.

def _bound(int_ops: float, nbytes: float):
    t_ops = int_ops / INT_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sha512_ops(lens: np.ndarray, row_bytes: int) -> int:
    """Per block: 80 rounds x 34 int32 ops (three 64-bit rotates = 6
    funnel shifts per Sigma, 3-input logic ops, 64-bit adds as 2 ops)
    + 64 schedule words x 22 ops + 16 for the state."""
    nblocks = (np.clip(lens, 0, row_bytes).astype(np.int64) + 17 + 127) // 128
    return int(nblocks.sum()) * (80 * 34 + 64 * 22 + 16)


# A Barrett reduction mod L of a 512-bit value, counted in 64 x 64-bit
# products (HAC 14.42 at b = 2^64): 5 x 5 for q1 mu and 14 for q3 L; a
# 256 x 256-bit product: 16. sha512.cuh runs the same work in 32-bit
# halves on carry chains (sc_reduce512, mul256).
BARRETT_PRODUCTS, MUL256_PRODUCTS = 39, 16


def bound_sha512_mod_l(lens: np.ndarray, row_bytes: int):
    """The rounds (_sha512_ops), then one Barrett reduction per lane."""
    return _bound(_sha512_ops(lens, row_bytes)
                  + len(lens) * BARRETT_PRODUCTS * 4,
                  len(lens) * (row_bytes + 4 + 32))


def bound_sha512_batch(lens: np.ndarray, row_bytes: int):
    """The rounds alone; reads the rows, writes 64-byte digests."""
    return _bound(_sha512_ops(lens, row_bytes),
                  len(lens) * (row_bytes + 4 + 64))


def bound_frontend_rlc(lens: np.ndarray, row_bytes: int):
    """The rounds, then per lane three Barrett reductions (h, z h, z s)
    and two 256-bit products; reads rows, z and s, writes h, m, zs."""
    per_lane = 3 * BARRETT_PRODUCTS + 2 * MUL256_PRODUCTS
    return _bound(_sha512_ops(lens, row_bytes) + len(lens) * per_lane * 4,
                  len(lens) * (row_bytes + 4 + 2 * 32 + 3 * 32))


def bound_decompress_so(n: int):
    """Per lane 267 squarings + 28 multiplies: the pow22523 chain (251 S
    + 11 M), the curve equation and root checks, and the three
    small-order doublings (12 S + 9 M)."""
    return _bound(n * (267 * IMAD_PER_SQ + 28 * IMAD_PER_MUL),
                  n * (32 + 4 * 40 + 2))


def bound_decompress_niels(n: int):
    """K2's chain (267 S + 28 M a lane) and the 2d T multiply of the
    niels forms. Reads 32 B a lane; writes the point, both niels forms
    and two masks."""
    return _bound(n * (267 * IMAD_PER_SQ + 29 * IMAD_PER_MUL),
                  n * (32 + 4 * 40 + 2 * 3 * 40 + 2))


def bound_double_scalarmult(n: int):
    """Per lane: the A table (1 + 14 x 9 multiplies), then 64 windows of
    4 doublings (16 S + 13 M) and two adds (8 + 6 M): 1024 S + 1855 M."""
    return _bound(n * (1024 * IMAD_PER_SQ + 1855 * IMAD_PER_MUL),
                  n * (64 + 4 * 40 + 3 * 40))


def bound_scalarmult_base(n: int):
    """K3 with h = 0, as signing calls it: the A table and the A adds
    are not needed, so 64 windows of 4 doublings (16 S + 13 M) and the
    B add (6 M): 1024 S + 1216 M a lane."""
    return _bound(n * (1024 * IMAD_PER_SQ + 1216 * IMAD_PER_MUL),
                  n * (64 + 4 * 40 + 3 * 40))


def bound_point_eq(n: int):
    """Per lane two multiplies; reads five field elements, writes 1 B."""
    return _bound(n * 2 * IMAD_PER_MUL, n * (5 * 40 + 1))


def bound_sc_reduce64(n: int):
    """A Barrett reduction a lane; reads 64 B, writes 32 B."""
    return _bound(n * BARRETT_PRODUCTS * 4, n * (64 + 32))


def bound_sc_muladd(n: int, addend: bool):
    """A 256-bit product and a Barrett reduction a lane; reads a, b (and
    c), writes 32 B."""
    return _bound(n * (MUL256_PRODUCTS + BARRETT_PRODUCTS) * 4,
                  n * (64 + 32 * addend + 32))


def bound_fe_pow(n: int, invert: bool):
    """The chain a lane: 254 squarings and 11 multiplies (z^(p - 2)) or
    251 and 11 (z^((p - 5)/8)); reads and writes 40 B."""
    return _bound(n * ((254 if invert else 251) * IMAD_PER_SQ
                       + 11 * IMAD_PER_MUL), n * 80)


def bound_compress(n: int):
    """The inversion chain (254 S + 11 M) and two multiplies a lane; reads
    X, Y, Z (120 B), writes 32 B."""
    return _bound(n * (254 * IMAD_PER_SQ + 13 * IMAD_PER_MUL), n * (120 + 32))


# The MSM kernels: a mixed add (madd) is 7 multiplies, a unified add 9, a
# doubling 4 squarings + 4 multiplies; a point crosses as 160 B of limbs.
IMAD_PER_DBL = 4 * IMAD_PER_SQ + 4 * IMAD_PER_MUL
PT_BYTES = 4 * 5 * 8


def _sum_bounds(bounds):
    """Bounds of one kernel's launches in a pass, summed (sequential
    launches); bound_by is the kind that bounds most of the total."""
    by_ops = sum(t for t, by in bounds if by == "operations")
    return sum(t for t, _ in bounds), (
        "operations" if 2 * by_ops >= sum(t for t, _ in bounds) else "bytes")


def bound_fill(lanes: int, rounds: int, filled: int, n_points: int):
    """A madd (7 multiplies) for each filled slot: the bucket sums need
    no more. The kernel's identity adds on empty slots exist only
    because it runs a static number of rounds, so they are not counted.
    Reads the niels forms (120 B a point) once and the slot table,
    writes the buckets."""
    return _bound(filled * 7 * IMAD_PER_MUL,
                  n_points * 3 * 40 + rounds * lanes * 4 + lanes * PT_BYTES)


def bound_aggregate(ncols: int, nb: int):
    """2 (nb - 2) unified adds per column."""
    return _bound(ncols * 2 * (nb - 2) * 9 * IMAD_PER_MUL,
                  ncols * (nb + 1) * PT_BYTES)


def bound_horner(nw: int, w_bits: int):
    """(nw - 1) x (w doublings + 1 unified add)."""
    return _bound((nw - 1) * (w_bits * IMAD_PER_DBL + 9 * IMAD_PER_MUL),
                  (nw + 1) * PT_BYTES)


def bound_order(k: int, order: int):
    """Per point a doubling for each bit of L below the leading one and a
    unified add for each set bit among them."""
    n_dbl = order.bit_length() - 1
    n_add = bin(order).count("1") - 1
    return _bound(k * (n_dbl * IMAD_PER_DBL + n_add * 9 * IMAD_PER_MUL),
                  2 * k * PT_BYTES)


def _op(t) -> str:
    """A SASS instruction's opcode without its predicate or modifiers."""
    return (t[1] if t[0].startswith("@") else t[0]).split(".")[0]


def function_sass(sass: str, function: str) -> list:
    """The instructions of a function in cuobjdump -sass output, as
    (address, tokens) pairs."""
    body = sass[sass.index(f"Function : {function}"):]
    end = body.find("Function :", 10)
    return [(int(a, 16), t.split()) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body[:end] if end > 0 else body)]


def inner_loops(sass: str, function: str) -> list:
    """The innermost backward branches of a function in cuobjdump -sass
    output, each as a list of its instructions' token lists (a thread's
    instructions an iteration)."""
    ins = function_sass(sass, function)
    loops = []
    for a, toks in ins:
        if "BRA" in toks and int(toks[-1], 16) < a:
            loops.append((int(toks[-1], 16), a))
    inner = [lp for lp in loops if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    return [[t for a, t in ins if lo <= a <= hi] for lo, hi in inner]


def cuobjdump_sass(path) -> str | None:
    """cuobjdump -sass of a library or cubin; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        return None
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def sass_loop(lib, function: str, pick):
    """Phase 2: the innermost loop of a kernel that pick (max or min with
    a key) selects from inner_loops, from cuobjdump -sass on its library;
    None without cuobjdump."""
    sass = cuobjdump_sass(lib)
    return None if sass is None else pick(inner_loops(sass, function))


def loop_mix(loop) -> str:
    """Instruction count and opcode mix of a sass_loop."""
    ops = collections.Counter(_op(t) for t in loop)
    n = sum(ops.values())
    return f"{n} instructions a thread: " + ", ".join(
        f"{k} {v} ({100 * v / n:.1f}%)" for k, v in ops.most_common(8))


def sass_loops(build) -> None:
    """Phase 2: K3's window loop (the largest), the decompress core's
    squaring loop in K2 and in compress (the smallest: lg_sqn's loop is
    not unrolled, one squaring an iteration), the SHA-512 core's round
    loop (the one with the most funnel shifts SHF: sw_rounds, 16 rounds
    an iteration) and the scalar kernels (scalar_sass)."""
    k3 = sass_loop(build.lib_path("double_scalarmult"), "_Z10dsm_kernel",
                   lambda lps: max(lps, key=len))
    if k3 is None:
        say("SASS: cuobjdump not found (not measured)")
        return
    say(f"K3 SASS window loop, a window: {loop_mix(k3)}")
    sq = sass_loop(build.lib_path("decompress_so"),
                   "_Z20decompress_so_kernel", lambda lps: min(lps, key=len))
    say(f"decompress core SASS squaring loop (K2), a squaring: "
        f"{loop_mix(sq)}")
    csq = sass_loop(build.lib_path("compress"), "_Z15compress_kernel",
                    lambda lps: min(lps, key=len))
    say(f"decompress core SASS squaring loop (compress), a squaring: "
        f"{loop_mix(csq)}")
    sha = sass_loop(build.lib_path("sha512_mod_l"),
                    "_Z19sha512_mod_l_kernelPKhxPKiPhx",
                    lambda lps: max(lps, key=lambda lp: sum(
                        _op(t) == "SHF" for t in lp)))
    say(f"SHA-512 core SASS round loop (K1), 16 rounds: "
        f"{loop_mix(sha)}")
    scalar_sass(build)


# A probe of the shared scalar chains alone: sha512.cuh's sc_reduce512
# and mul256 between 8-byte loads and stores, built for sm_90a and read
# in SASS, so that two checkouts' chains compare on the same frame.
CHAIN_PROBE = r"""#include "sha512.cuh"
__global__ void probe_sc_reduce512(const u64 *in, u64 *out) {
  const int i = threadIdx.x;
  u64 x[8], r[4];
#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = in[8 * i + k];
  sc_reduce512(x, r);
#pragma unroll
  for (int k = 0; k < 4; k++) out[4 * i + k] = r[k];
}
__global__ void probe_mul256(const u64 *in, u64 *out) {
  const int i = threadIdx.x;
  u64 a[4], b[4], p[8];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    a[k] = in[8 * i + k];
    b[k] = in[8 * i + 4 + k];
  }
  mul256(a, b, p);
#pragma unroll
  for (int k = 0; k < 8; k++) out[8 * i + k] = p[k];
}
"""
# Opcodes of the probe's frame, not of the chain.
PROBE_FRAME = ("LDG", "STG", "S2R", "EXIT", "BRA", "NOP")
# The scalar kernels' symbols: straight-line code, the staging and the
# carry chains of sha512.cuh (no loop but the byte path's).
SC_SYMBOLS = {"sc_reduce64": "_Z18sc_reduce64_kernel",
              "sc_muladd": "_Z16sc_muladd_kernel"}


def scalar_sass(build) -> None:
    """Phase 2: the scalar kernels' whole functions in SASS (staging,
    muladd256 and sc_reduce512), then CHAIN_PROBE built against build's
    sources: each chain's instructions (the probe's loads, stores, index
    and exit left out). Instruction counts and opcode mixes; "not
    measured" without cuobjdump."""
    sass = cuobjdump_sass(build.lib_path("sc_reduce"))
    if sass is None:
        say("scalar kernels SASS: cuobjdump not found (not measured)")
        return
    for name, sym in SC_SYMBOLS.items():
        say(f"{name} SASS, the whole kernel: " + loop_mix(
            [t for _, t in function_sass(sass, sym) if _op(t) != "NOP"]))
    src = build.BUILD_DIR / "chain_probe.cu"
    src.write_text(CHAIN_PROBE)
    cubin = src.with_suffix(".cubin")
    subprocess.run([build.find_nvcc(), "-cubin", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I",
                    str(build.CSRC), "-o", str(cubin), str(src)], check=True,
                   capture_output=True)
    sass = cuobjdump_sass(cubin)
    for name in ("sc_reduce512", "mul256"):
        ins = [t for _, t in function_sass(
            sass, f"_Z{6 + len(name)}probe_{name}") if _op(t) not in PROBE_FRAME]
        say(f"{name} chain SASS ({build.CSRC}): {loop_mix(ins)}")


def ptxas_line(build, name: str) -> str:
    """ptxas's registers, stack frame and spills of a kernel's library."""
    return " | ".join(ln.strip() for ln in build.ptxas_report().get(
        name, "").splitlines() if "registers" in ln or "spill" in ln)


def check_no_stack(build, name: str) -> None:
    """ptxas must report 0 bytes of stack and 0 spills for every entry of
    a kernel's library; prints its registers, stack, spills and shared
    memory."""
    rep = build.ptxas_report().get(name, "")
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", rep)
    say(f"{name} resources: {ptxas_line(build, name)}")
    if not frames or any(int(v) for f in frames for v in f):
        fail(f"{name}: ptxas reports stack or spills ({frames})")


# ------------------------------------------------------------- timing

def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def trace_device_ms(prof, kernel: str) -> float | None:
    """Mean device time of a launch of the kernels whose name starts with
    kernel in a torch.profiler trace (after the "void " that a template
    kernel's name starts with), over the launches the trace holds (it may
    drop some); None when the trace shows no device time."""
    from torch.autograd import DeviceType

    total, count = 0.0, 0
    for ev in prof.key_averages():
        if (getattr(ev, "device_type", None) == DeviceType.CUDA
                and ev.key.removeprefix("void ").startswith(kernel)):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            total, count = total + dev_us, count + ev.count
    return total / 1e3 / count if total > 0 else None


def after_other(torch, other, fn, kernel: str,
                reps: int = REPS) -> tuple[float, float | None]:
    """fn launched right after other, reps times under torch.profiler:
    the mean ms of fn by CUDA events around it alone, and by the trace's
    device time of its kernel (trace_device_ms). fn runs with the caches
    other left behind, where time_ms gives it warm from its own previous
    launch."""
    from torch.profiler import ProfilerActivity, profile

    times = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            other()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
    return sum(times) / reps, trace_device_ms(prof, kernel)


def traced_ms(torch, fn, kernel: str, reps: int = REPS) -> float | None:
    """Mean device time of kernel over reps warm calls of fn under
    torch.profiler (trace_device_ms). It times a kernel shorter than its
    wrapper's host path, where CUDA events around back-to-back calls time
    the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return trace_device_ms(prof, kernel)


def trace_busy(prof) -> tuple[float, int]:
    """Seconds of device time and device operations in a torch.profiler
    trace."""
    from torch.autograd import DeviceType

    busy, ops = 0.0, 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            busy += dev_us / 1e6
            ops += ev.count
    return busy, ops


def trace_kernels_ms(prof, prefix: str) -> tuple[float, int]:
    """Total ms of device time and launches of the kernels whose name
    starts with prefix in a torch.profiler trace."""
    from torch.autograd import DeviceType

    total, count = 0.0, 0
    for ev in prof.key_averages():
        if (getattr(ev, "device_type", None) == DeviceType.CUDA
                and ev.key.removeprefix("void ").startswith(prefix)):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            total, count = total + dev_us / 1e3, count + ev.count
    return total, count


def profile_batches(torch, fn, batch_ms: float, n: int = 3) -> None:
    """Device time by kernel over n batches (torch.profiler), and the
    device's busy and idle share of batch_ms, the batch time measured
    without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels.append((dev_us / n, ev.key, ev.count // n))
    if not kernels:
        say("profile: the trace shows no device time (not measured)")
        return
    busy = sum(k[0] for k in kernels)
    share = busy / (batch_ms * 1e3)
    say(f"profile over {n} batches: {sum(k[2] for k in kernels)} device "
        f"operations per batch, device busy {busy:.1f} us/batch = "
        f"{100 * share:.1f}% of the {batch_ms:.3f} ms batch, idle "
        f"{100 - 100 * share:.1f}%")
    for dev_us, key, count in sorted(kernels, reverse=True):
        say(f"  {dev_us:9.1f} us/batch {100 * dev_us / busy:5.1f}% "
            f"x{count} {key[:60]}")


def max_abs_err(torch, a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    if a.shape != b.shape:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def _device_note(torch, fn, trace) -> str:
    """", device t ms" by the trace's device time of the kernels named
    trace (traced_ms) over REPS calls of fn; "" without trace."""
    if trace is None:
        return ""
    t = traced_ms(torch, fn, trace)
    return f", device {'not measured' if t is None else f'{t:.4f} ms'}"


def kernel_pass(torch, parity, record, name, runs, replaces, source,
                trace=None):
    """runs: (label, kernel fn, plain fn, bound) per launch of a pass;
    each launch held against its plain version and timed (CUDA events;
    with trace, the kernel symbol's prefix, also the trace's device time,
    printed); one JSON row with the pass's summed times and bounds.
    Returns the kernel outputs by label."""
    err = ms = plain_ms = 0.0
    outs = {}
    for label, kern, plain, bound in runs:
        out = kern()
        err = max(err, parity(f"{name} {label}", out, plain()))
        k_ms, p_ms = time_ms(torch, kern, REPS), time_ms(torch, plain, 1)
        say(f"  {name} {label}: kernel {k_ms:.4f} ms"
            f"{_device_note(torch, kern, trace)}, plain "
            f"{p_ms:.1f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        outs[label] = out
    record(name, err, ms, plain_ms, _sum_bounds([r[3] for r in runs]),
           replaces, source)
    return outs


def _le(values, width: int) -> np.ndarray:
    return np.array([list(v.to_bytes(width, "little")) for v in values],
                    np.uint8).reshape(len(values), width)


def _limbs51(torch, values, dev):
    """Python ints -> (n, 5) int64 radix-2^51 limbs on dev."""
    return torch.tensor([[(v >> (51 * i)) & ((1 << 51) - 1)
                          for i in range(5)] for v in values],
                        dtype=torch.int64, device=dev).reshape(-1, 5)


def _high_limbs(v: int) -> list:
    """Radix-2^51 limbs of a value congruent to v mod p with every limb in
    [2^51, 2^52): 2^51 plus the canonical limbs of v - S mod p, S the
    value of five limbs of 2^51."""
    p = 2**255 - 19
    r = (v - sum(1 << (51 * i + 51) for i in range(5))) % p
    return [(1 << 51) + ((r >> (51 * i)) & ((1 << 51) - 1)) for i in range(5)]


def _edge_points(torch, rng, dev):
    """(n, 3, 5) limbs of compress's edge points: the identity (0:1:1)
    and (0:lambda:lambda), the torsion points and the points with y
    within 19 of p, each at Z = 1 and at a random Z; then Z = 0 lanes
    (0:0:0 and random X, Y), which encode as zero bytes; then the points
    again with every limb of X, Y and Z in [2^51, 2^52) (the kernel's
    input range, not canonical)."""
    from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle

    p = oracle.P
    aff = [(0, 1)] + list(dict.fromkeys(
        oracle.point_decompress(e) for e in corpus.torsion_encodings()))
    for k in range(1, 20):
        x = oracle._recover_x(p - k, 0)
        if x:
            aff += [(x, p - k), (p - x, p - k)]
    pts = []
    for x, y in aff:
        lam = int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1
        pts += [(x, y, 1), (x * lam % p, y * lam % p, lam)]
    pts += [(0, 0, 0)] + [tuple(int.from_bytes(rng.bytes(32), "little") % p
                                for _ in range(2)) + (0,) for _ in range(7)]
    canon = torch.stack([_limbs51(torch, [q[c] for q in pts], dev)
                         for c in range(3)], dim=1)
    high = torch.tensor([[_high_limbs(v) for v in q] for q in pts],
                        dtype=torch.int64, device=dev)
    return torch.cat([canon, high])


def hash_rows(torch, gpu, dev) -> dict:
    """Rows of the warp-staged hash kernels beside the main path's (own
    seed, so that the later phases' inputs stay as they were): stride
    1299 (rows off every 16-byte boundary) with lengths 0, 111, 112, 239,
    240, 1231 and max_len planted, and 256-byte rows starting 3 bytes
    past an aligned address (aligned words joined by funnel shifts)."""
    rng = np.random.RandomState(17)
    lens = rng.randint(0, 1300, B).astype(np.int32)
    lens[:7] = [0, 111, 112, 239, 240, 1231, 1299]
    odd = gpu(rng.randint(0, 256, B * 256 + 3, dtype=np.uint8))[3:]
    return {"stride 1299": (gpu(rng.randint(0, 256, (B, 1299),
                                            dtype=np.uint8)), gpu(lens)),
            "256-byte rows at base + 3": (
                odd.view(B, 256),
                torch.full((B,), 256, dtype=torch.int32, device=dev))}


def sign_hash_rows(torch, gpu, dev) -> list:
    """sha512_batch's signing rows beside K1's shapes (own seed): the
    32-byte seeds and prefix || msg at (s1), 32 + 192 = 224 bytes (the
    16-byte path), lengths 0, 1, 31, 111, 112, 223 planted below the full
    row."""
    rng = np.random.RandomState(19)
    out = []
    for row, head in ((32, [0, 1, 31]), (32 + MSG_LEN, [0, 111, 112, 223])):
        lens = np.full(B, row, np.int32)
        lens[:len(head)] = head
        out.append((f"{row}-byte rows", (gpu(rng.randint(
            0, 256, (B, row), dtype=np.uint8)), gpu(lens))))
    return out


def hash_shapes(parity, name, shapes, kern, plain) -> float:
    """A hash kernel against its plain version on each (label, args) of
    shapes, on all B lanes and on the first n of HASH_RAGGED (the plain
    version works row by row, so its first n rows are its output on
    them). Returns the largest error."""
    err = 0.0
    for label, args in shapes:
        want = plain(*args)
        err = max(err, parity(f"{name} ({label})", kern(*args), want))
        for n in HASH_RAGGED:
            cut = kern(*(a[:n] for a in args))
            err = max(err, parity(
                f"{name} ({label}, n = {n})", cut,
                tuple(w[:n] for w in want) if isinstance(want, tuple)
                else want[:n]))
    return err


def hash_timed(torch, name, kern, kernel) -> float:
    """A hash kernel's time at the main path's shape: CUDA events around
    REPS wrapper calls, returned as every row's ms is, and the trace's
    device time printed beside it."""
    events = time_ms(torch, kern, REPS)
    say(f"  {name} {B} x 256-byte rows: {events:.4f} ms a call by CUDA "
        f"events (the wrapper's host path bounds it)"
        f"{_device_note(torch, kern, kernel)} by the trace")
    return events


def k3_edges(torch, gpu, parity, a_pt, h, s) -> None:
    """Phase 3, K3 on its edges, limb for limb against its plain version:
    h and s of 0, 1, 15, 2^256 - 1 and nibbles alternating 0 and 15, on
    A = each torsion point (the identity, order 2, 4 and 8) and the base
    point, at Z = 1 and at a random Z; the general batch fills the rest.
    Launched at n = 1, 31, 33 and B - 1 lanes: the ragged tails of the
    32-lane block, whose dead quads rerun lane n - 1 and store nothing.
    16 edge lanes are also held as affine bytes against the oracle."""
    from firedancer_tpu_torch import convert
    from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
    from firedancer_tpu_torch.ops import dsm_cuda

    p = oracle.P
    rng = np.random.RandomState(11)
    aff = list(dict.fromkeys(oracle.point_decompress(e)
                             for e in corpus.torsion_encodings()))
    aff.append(oracle.B)
    pts = []
    for x, y in aff:
        lam = int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1
        for z in (1, lam):
            pts.append((x * z % p, y * z % p, z, x * y * z % p))
    scalars = [0, 1, 15, 2**256 - 1, int.from_bytes(b"\x0f" * 32, "little"),
               int.from_bytes(b"\xf0" * 32, "little")]
    cases = [(hv, pt, sv) for pt in pts for hv in scalars for sv in scalars]
    dev = a_pt.device
    n_all = B - 1
    ea = a_pt[:n_all].clone()
    eh, es = h[:n_all].clone(), s[:n_all].clone()
    ea[:len(cases)] = torch.stack([_limbs51(torch, [c[1][k] for c in cases],
                                            dev) for k in range(4)], dim=1)
    eh[:len(cases)] = gpu(_le([c[0] for c in cases], 32))
    es[:len(cases)] = gpu(_le([c[2] for c in cases], 32))
    for n in (1, 31, 33, n_all):
        parity(f"double_scalarmult edges, {n} lanes",
               dsm_cuda.double_scalarmult_cuda(eh[:n], ea[:n], es[:n]),
               dsm_cuda.double_scalarmult_ref(eh[:n], ea[:n], es[:n]))
    got = dsm_cuda.double_scalarmult_cuda(eh[:n_all], ea[:n_all], es[:n_all])
    picks = np.linspace(0, len(cases) - 1, 16).astype(int)
    enc = convert.point_to_affine_bytes(got[torch.as_tensor(picks,
                                                            device=dev)])
    for row, k in zip(enc, picks):
        hv, (x, y, z, _), sv = cases[k]
        zi = pow(z, p - 2, p)
        neg_a = ((p - x * zi % p) % p, y * zi % p)
        want = oracle.point_add(oracle.scalarmult(hv, neg_a),
                                oracle.scalarmult(sv, oracle.B))
        if row.tobytes() != oracle.point_compress(want):
            fail(f"double_scalarmult: edge lane {k} differs from the oracle")
    say(f"double_scalarmult edges: {len(cases)} edge lanes (h, s in "
        f"{{0, 1, 15, 2^256 - 1, 0x0f.., 0xf0..}}, {len(aff)} points at "
        f"Z = 1 and Z != 1) at n = 1, 31, 33 and {n_all} equal the plain "
        "version limb for limb; 16 equal the oracle")


def fe_pow_parity(torch, parity, record, rng, dev) -> None:
    """Phase 3, fe_pow (off the paths): both chains on B lanes of values
    below 2^255 with the edges planted (the row's times), then on 2B
    lanes at every n of GROUP_RAGGED, cut from lane 0 and from where the
    edges meet random lanes, limb for limb; the trace's device time a
    launch at each n of POW_TIMED. Edges: z = 0, 1, 2, p - 1; p, p + 1,
    p + 18 and 2^255 - 1 (limbs below 2^51); 0, 1, p - 1 and a random
    value with every limb in [2^51, 2^52); every limb 2^52 - 1."""
    from firedancer_tpu_torch.ballet.ed25519 import oracle
    from firedancer_tpu_torch.ops import pow_cuda

    P = oracle.P
    pe = [0, 1, 2, P - 1, P, P + 1, P + 18, 2**255 - 1]
    zv = [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(B)]
    zv[:len(pe)] = pe
    high = torch.tensor([_high_limbs(v) for v in (0, 1, P - 1, zv[-1])]
                        + [[(1 << 52) - 1] * 5], dtype=torch.int64,
                        device=dev)
    n_edge = len(pe) + high.shape[0]
    own = np.random.RandomState(23)
    z2 = torch.cat([_limbs51(torch, zv, dev), _limbs51(torch, [
        int.from_bytes(own.bytes(32), "little") >> 1 for _ in range(B)],
        dev)])
    z2[len(pe):n_edge] = high
    zl = z2[:B]
    chains = (("invert", pow_cuda.fe_invert_cuda, pow_cuda.fe_invert_ref),
              ("pow22523", pow_cuda.fe_pow22523_cuda,
               pow_cuda.fe_pow22523_ref))
    kernel_pass(torch, parity, record, "fe_pow", [
        (f"{name} {B} lanes", lambda k=k: k(zl), lambda r=r: r(zl),
         bound_fe_pow(B, name == "invert")) for name, k, r in chains],
        "firedancer_tpu/ops/pow_pallas.py:148",
        "firedancer_tpu_torch/ops/csrc/fe_pow.cu", "fe_pow_kernel")
    for name, kern, plain in chains:
        for n in GROUP_RAGGED:
            for off in sorted({0, min(n_edge - 3, 2 * B - n)}):
                cut = z2[off:off + n]
                parity(f"fe_pow {name} ({n} lanes from lane {off})",
                       kern(cut), plain(cut))
        for n in POW_TIMED:
            t = traced_ms(torch, lambda k=kern, n=n: k(z2[:n]),
                          "fe_pow_kernel")
            say(f"  fe_pow {name} at {n} lanes: device "
                f"{'not measured' if t is None else f'{t:.4f} ms'}, bound "
                f"{bound_fe_pow(n, name == 'invert')[0]:.6f} ms")
    say(f"fe_pow: both chains equal on {n_edge} planted edge lanes at n = "
        f"{', '.join(map(str, GROUP_RAGGED))}")


def point_eq_inputs(torch, gpu, a_pt, lam):
    """(aff (2B, 4, 5), proj (2B, 3, 5)) limbs for point_eq: lane i holds
    the decoded point a_pt[i mod B] as (X, Y, 1, T), against
    (x Z : y Z : Z) by kind (its own seed; about half equal): equal at
    Z = 1; equal at Z = lam; only X differs (X + 1); only Y differs
    (Y + 1, Z = 1); equal with every limb of all five coordinates
    canonical + p (limbs in [2^51 - 19, 2^52)); the previous lane's
    point (both differ)."""
    from firedancer_tpu_torch.ops import fe25519 as fe

    dev = a_pt.device
    n = 2 * B
    own = np.random.RandomState(29)
    kind = gpu(own.randint(0, 6, n))
    pts = a_pt[torch.arange(n, device=dev) % B]
    lam2 = torch.cat([lam, fe.fe_from_bytes(gpu(own.randint(
        0, 256, (B, 32), dtype=np.uint8)))])
    one = fe.fe_from_limbs51(torch.tensor([1, 0, 0, 0, 0], dtype=torch.int64,
                                          device=dev).expand(n, 5))

    def pick(mask, a, b):
        return torch.where(mask[:, None], a, b)

    z = pick((kind == 0) | (kind == 3), one, lam2)
    x, y = (fe.fe_from_limbs51(pts[:, c]) for c in (0, 1))
    X, Y = fe.fe_mul(x, z), fe.fe_mul(y, z)
    X = pick(kind == 2, fe.fe_add(X, one), X)
    Y = pick(kind == 3, fe.fe_add(Y, one), Y)
    proj = torch.stack([fe.fe_to_limbs51(c) for c in (X, Y, z)], dim=1)
    aff = torch.where((kind == 5)[:, None, None], pts.roll(1, 0), pts)
    plus_p = torch.tensor([(1 << 51) - 19] + [(1 << 51) - 1] * 4,
                          dtype=torch.int64, device=dev)
    high = (kind == 4)[:, None, None]
    aff[:, :2] = torch.where(high, aff[:, :2] + plus_p, aff[:, :2])
    proj = torch.where(high, proj + plus_p, proj)
    return aff.contiguous(), proj.contiguous()


def point_eq_parity(torch, parity, aff4, proj3) -> None:
    """Phase 3, point_eq on the five-thread group: at every n of
    GROUP_RAGGED with aff of 2 and 4 coordinates and proj of 3 and 4
    (T: another lane's limbs, not read), byte for byte; the trace's
    device time a launch at each n of EQ_TIMED."""
    from firedancer_tpu_torch.ops import curve_cuda

    affs = {2: aff4[:, :2].contiguous(), 4: aff4}
    projs = {3: proj3, 4: torch.cat([proj3, aff4[:, 3:]], dim=1)}
    for n in GROUP_RAGGED:
        for ac, a in affs.items():
            for pc, q in projs.items():
                parity(f"point_eq ({n} lanes, aff {ac}, proj {pc} "
                       f"coordinates)", curve_cuda.point_eq_affine_cuda(
                           a[:n], q[:n]),
                       curve_cuda.point_eq_affine_ref(a[:n], q[:n]))
    for n in EQ_TIMED:
        t = traced_ms(torch, lambda n=n: curve_cuda.point_eq_affine_cuda(
            aff4[:n], proj3[:n]), "point_eq_kernel")
        say(f"  point_eq at {n} lanes: device "
            f"{'not measured' if t is None else f'{t:.4f} ms'}, bound "
            f"{bound_point_eq(n)[0]:.6f} ms")
    say(f"point_eq: equal at n = {', '.join(map(str, GROUP_RAGGED))} with "
        f"aff of 2 and 4 and proj of 3 and 4 coordinates; "
        f"{int(curve_cuda.point_eq_affine_cuda(aff4, proj3).sum())}/{2 * B} "
        f"lanes equal")


def sign_kernel_parity(torch, gpu, parity, record, rng) -> None:
    """Phase 3, the signing path's kernels at a signing call's shapes
    (B = 8192): sc_reduce64 (two launches), sc_muladd (one, c = r), fe_pow
    (both chains, off the paths: fe_pow_parity), compress (two, on K3's
    outputs); K3 with h = 0 and clamped scalars; sha512_batch on 1344-byte
    rows; and sc_muladd at the staged pass's shape (2B lanes, c = 0)."""
    from firedancer_tpu_torch import convert
    from firedancer_tpu_torch.ballet.ed25519 import oracle
    from firedancer_tpu_torch.ops import (curve_cuda, dsm_cuda, frontend_cuda,
                                          sc_cuda, sign)

    L = oracle.L

    def timed(label, kern, plain, bound=None, trace=None):
        """A launch outside a pass row: parity and time (with trace, also
        the trace's device time), printed."""
        parity(label, kern(), plain())
        extra = f", bound {bound[0]:.4f} ms ({bound[1]})" if bound else ""
        say(f"  {label}: kernel {time_ms(torch, kern, REPS):.4f} ms"
            f"{_device_note(torch, kern, trace)}, plain "
            f"{time_ms(torch, plain, 1):.1f} ms{extra}")

    # sc_reduce64: the digests of r and h; edges planted in r's.
    edges = [0, 1, L - 1, L, L + 1, 2 * L, 2**255 - 1, 2**256 - 1, 2**511,
             2**512 - 1]
    x_np = rng.randint(0, 256, (2, B, 64), dtype=np.uint8)
    x_np[0, :len(edges)] = _le(edges, 64)
    xs = [gpu(x_np[0]), gpu(x_np[1])]
    dev = xs[0].device
    red = kernel_pass(torch, parity, record, "sc_reduce64", [
        (f"{name} {B} x 64 B", lambda v=v: sc_cuda.sc_reduce64_cuda(v),
         lambda v=v: sc_cuda.sc_reduce64_ref(v), bound_sc_reduce64(B))
        for name, v in (("r", xs[0]), ("h", xs[1]))],
        "firedancer_tpu/ops/sc_pallas.py:141",
        "firedancer_tpu_torch/ops/csrc/sc_reduce.cu", "sc_reduce64_kernel")
    got = red[f"r {B} x 64 B"][:len(edges)].cpu().numpy()
    if [int.from_bytes(r.tobytes(), "little") for r in got] != \
            [v % L for v in edges]:
        fail("sc_reduce64: an edge lane is not x mod L")

    # sc_muladd: s = h a + r with a clamped, h and r < L (edges planted:
    # a, b, c of 0, L - 1, L, 2^255 - 1, 2^256 - 1); c = 0 at the staged
    # pass's 2B stacked lanes.
    a_np = rng.randint(0, 256, (B, 32), dtype=np.uint8)
    a_np[:, 0] &= 248
    a_np[:, 31] = (a_np[:, 31] & 63) | 64
    h_t, r_t = (sc_cuda.sc_reduce64_ref(v) for v in xs)
    a_t = gpu(a_np)
    mx = [0, L - 1, L, 2**255 - 1, 2**256 - 1]
    for t, pick in ((h_t, lambda i: mx[i // 5]), (a_t, lambda i: mx[i % 5]),
                    (r_t, lambda i: mx[3 * i % 5])):
        t[:25] = gpu(_le([pick(i) for i in range(25)], 32))
    ma_out = kernel_pass(torch, parity, record, "sc_muladd", [(
        f"s = h a + r, {B} lanes",
        lambda: sc_cuda.sc_muladd_cuda(h_t, a_t, r_t),
        lambda: sc_cuda.sc_muladd_ref(h_t, a_t, r_t),
        bound_sc_muladd(B, True))],
        "firedancer_tpu/ops/sc_pallas.py:111",
        "firedancer_tpu_torch/ops/csrc/sc_reduce.cu", "sc_muladd_kernel")
    ints = [[int.from_bytes(r.tobytes(), "little") for r in
             t[:25].cpu().numpy()] for t in (h_t, a_t, r_t,
                                             *ma_out.values())]
    if ints[3] != [(h * a + r) % L for h, a, r in zip(*ints[:3])]:
        fail("sc_muladd: an edge lane is not (h a + r) mod L")
    z_np = rng.randint(0, 256, (B, 32), dtype=np.uint8)
    z_np[:, 16:] = 0
    zz, hs = gpu(np.concatenate([z_np, z_np])), torch.cat([h_t, xs[1][:, :32]])
    timed(f"sc_muladd c = 0, staged z||z h||s, {2 * B} lanes",
          lambda: sc_cuda.sc_muladd_cuda(zz, hs),
          lambda: sc_cuda.sc_muladd_ref(zz, hs), bound_sc_muladd(2 * B, False),
          "sc_muladd_kernel")

    fe_pow_parity(torch, parity, record, rng, dev)

    # K3 as signing calls it (h = 0, the base point, clamped a and r < L),
    # then compress on its outputs with the edge points planted (Z = 0 and
    # non-canonical limbs among them), also at the ragged n of the
    # five-thread group (six lanes a warp) and with a T column.
    zero = torch.zeros_like(a_t)
    base = sign._b_rows(dev, B)
    k3 = {}
    for name, sc_t in (("pub = a B", a_t), ("R = r B", r_t)):
        timed(f"double_scalarmult h = 0, {name}, {B} lanes",
              lambda v=sc_t: dsm_cuda.double_scalarmult_cuda(zero, base, v),
              lambda v=sc_t: dsm_cuda.double_scalarmult_ref(zero, base, v),
              bound_scalarmult_base(B))
        k3[name] = dsm_cuda.double_scalarmult_cuda(zero, base, sc_t)
    edge_pts = _edge_points(torch, rng, dev)
    k3["pub = a B"][:edge_pts.shape[0]] = edge_pts
    enc = kernel_pass(torch, parity, record, "compress", [
        (f"{name} {B} lanes", lambda p=p: curve_cuda.compress_cuda(p),
         lambda p=p: curve_cuda.compress_ref(p), bound_compress(B))
        for name, p in k3.items()],
        "firedancer_tpu/ops/curve_pallas.py:340",
        "firedancer_tpu_torch/ops/csrc/compress.cu", "compress_kernel")
    pub, n_edge = k3["pub = a B"], edge_pts.shape[0]
    for n in RAGGED + (B - 3,):
        for off in sorted({0, min(n_edge - 3, B - n)}):
            cut = pub[off:off + n]
            parity(f"compress ({n} lanes from lane {off})",
                   curve_cuda.compress_cuda(cut),
                   curve_cuda.compress_ref(cut))
    with_t = torch.cat([pub, pub[:, :1]], dim=1)
    parity("compress ((B, 4, 5) points: T not read)",
           curve_cuda.compress_cuda(with_t), curve_cuda.compress_ref(with_t))
    zero_z = enc[f"pub = a B {B} lanes"][:n_edge].view(2, -1, 32)[:, -8:]
    if zero_z.any():
        fail("compress: a Z = 0 lane does not encode as zero bytes")
    say(f"compress: equal on {n_edge} planted edge lanes (Z = 0, limbs in "
        f"[2^51, 2^52)), at n = {', '.join(map(str, RAGGED))} and {B - 3} "
        f"and with a T column")
    parity("compress vs the affine encoding (512 lanes)",
           enc[f"pub = a B {B} lanes"][:512].cpu().numpy(),
           convert.point_to_affine_bytes(k3["pub = a B"][:512]))
    r_enc = enc[f"R = r B {B} lanes"].cpu().numpy()
    for i in range(16):
        r_int = int.from_bytes(r_t[i].cpu().numpy().tobytes(), "little")
        if r_enc[i].tobytes() != oracle.point_compress(
                oracle.scalarmult(r_int, oracle.B)):
            fail(f"compress(K3 r B): lane {i} differs from the oracle")

    # sha512_batch on signing's longest rows: R || pub || msg in the
    # 1280-byte bucket, 1344 bytes, every block count 1-11.
    row = 64 + 1280
    sl = rng.randint(0, row + 1, B).astype(np.int32)
    sl[:8] = [0, 111, 112, 239, 240, 1231, row - 1, row]
    s_rows, s_lens = gpu(rng.randint(0, 256, (B, row), dtype=np.uint8)), gpu(sl)
    hash_shapes(parity, "sha512_batch", [(f"rows of {row} bytes",
                                          (s_rows, s_lens))],
                frontend_cuda.sha512_batch_cuda,
                frontend_cuda.sha512_batch_ref)
    timed(f"sha512_batch, rows of {row} bytes",
          lambda: frontend_cuda.sha512_batch_cuda(s_rows, s_lens),
          lambda: frontend_cuda.sha512_batch_ref(s_rows, s_lens),
          bound_sha512_batch(sl, row), "sha512_batch_kernel")
    say("signing kernels: sc_reduce64, sc_muladd, fe_pow, compress and K3 "
        "with h = 0 equal their plain versions; the edge lanes equal "
        "Python's integers and the oracle")


def _at_offset(torch, arr: np.ndarray, off: int, dev):
    """arr's bytes as a contiguous view off bytes into a flat uint8
    buffer on dev (the allocator's base is 16-byte aligned)."""
    flat = torch.zeros(off + arr.size, dtype=torch.uint8, device=dev)
    flat[off:] = torch.from_numpy(np.ascontiguousarray(arr).ravel()).to(dev)
    return flat[off:].view(arr.shape)


def sc_grid_parity(torch, parity, dev) -> None:
    """Phase 3, the scalar kernels' grid: sc_reduce64 and sc_muladd (with
    c and with c = None) at every n of SC_RAGGED, each input a contiguous
    view at each byte offset of SC_OFFSETS into a flat buffer (the
    staging's 16-byte, 8-byte and byte accesses), the edges planted at
    the start and in the last block of B - 3, B and 2B lanes; every
    launch byte for byte against its plain version. Then each kernel's
    device time by the trace at the n of SC_TIMED (n = 1: the launch's
    fixed cost) and each offset, beside its CUDA-event time."""
    from firedancer_tpu_torch.ballet.ed25519 import oracle
    from firedancer_tpu_torch.ops import sc_cuda

    L = oracle.L
    rng = np.random.RandomState(31)
    n_all = max(SC_RAGGED)
    red = [0, 1, L - 1, L, L + 1, 2 * L, 3 * L, 2**252, 2**255 - 1,
           2**256 - 1, L * L, 2**511, 2**512 - 1, (2**512 - 1) // L * L]
    mx = [0, 1, L - 1, L, 2**255 - 1, 2**256 - 1]
    trip = [(a, b, c) for a in mx for b in mx for c in mx]
    x = rng.randint(0, 256, (n_all, 64), dtype=np.uint8)
    abc = [rng.randint(0, 256, (n_all, 32), dtype=np.uint8)
           for _ in range(3)]
    x[:len(red)] = _le(red, 64)
    for k in range(3):
        abc[k][:len(trip)] = _le([t[k] for t in trip], 32)
    for end in (B - 3, B, 2 * B):
        x[end - len(red):end] = _le(red, 64)
        for k in range(3):
            abc[k][end - len(trip):end] = _le([t[k] for t in trip], 32)
    kernels = {
        "sc_reduce64": (1, sc_cuda.sc_reduce64_cuda,
                        sc_cuda.sc_reduce64_ref, "sc_reduce64_kernel"),
        "sc_muladd with c": (3, sc_cuda.sc_muladd_cuda,
                             sc_cuda.sc_muladd_ref, "sc_muladd_kernel"),
        "sc_muladd c = 0": (2, sc_cuda.sc_muladd_cuda,
                            sc_cuda.sc_muladd_ref, "sc_muladd_kernel")}
    for off in SC_OFFSETS:
        views = [_at_offset(torch, v, off, dev) for v in (x, *abc)]
        for name, (k, kern, plain, sym) in kernels.items():
            args = views[:1] if k == 1 else views[1:1 + k]
            for n in SC_RAGGED:
                cut = [v[:n] for v in args]
                parity(f"{name} ({n} lanes at offset {off})", kern(*cut),
                       plain(*cut))
            for n in SC_TIMED:
                cut = [v[:n] for v in args]

                def fn(cut=cut, kern=kern):
                    return kern(*cut)

                say(f"  {name} {n} lanes at offset {off}: "
                    f"{time_ms(torch, fn, REPS):.4f} ms by CUDA events"
                    f"{_device_note(torch, fn, sym)} by the trace")
    say(f"scalar kernels: sc_reduce64 and sc_muladd (c given and c = 0) "
        f"equal their plain versions byte for byte at n = "
        f"{', '.join(map(str, SC_RAGGED))}, inputs at byte offsets "
        f"{', '.join(map(str, SC_OFFSETS))}, {len(red)} reduction and "
        f"{len(trip)} product edges planted at the start and in the last "
        f"block")


def signing_path(torch, gpu, rows, card) -> None:
    """Phase 6: sign_jobs at the two shapes, each call's launch counts
    (reset just before, read just after), its bytes against the plain
    composition and the oracle, the signed batch through the direct and
    rlc engines, signatures/s and the device time by kernel."""
    from firedancer_tpu_torch.ballet.ed25519 import oracle
    from firedancer_tpu_torch.disco import corpus as dcorpus
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops import backend, sign

    rng = np.random.RandomState(9)
    for bsz, desc in SIGN_SHAPES:
        if bsz == B:
            lens = np.full(bsz, MSG_LEN, np.int32)
        else:
            lens = rng.randint(100, MTU_MSG + 1, bsz).astype(np.int32)
            lens[:2] = [100, MTU_MSG]
        row = -(-int(lens.max()) // dcorpus.LEN_BUCKET) * dcorpus.LEN_BUCKET
        msgs = rng.randint(0, 256, (bsz, row), dtype=np.uint8)
        msgs[np.arange(row)[None, :] >= lens[:, None]] = 0
        seeds = rng.randint(0, 256, (bsz, 32), dtype=np.uint8)
        jobs = [(msgs[i, :lens[i]].tobytes(), seeds[i].tobytes())
                for i in range(bsz)]
        torch.cuda.synchronize()
        backend.reset_counts()
        t0 = time.perf_counter()
        sigs = dcorpus.sign_jobs(jobs, batch=bsz)
        jobs_s = time.perf_counter() - t0
        launches, plain = dict(backend.launches), dict(backend.plain_calls)
        say(f"sign_jobs B={bsz} ({desc}, rows of {row} bytes): launches "
            f"{launches}, plain calls {plain}, {jobs_s:.3f} s with the "
            f"host's packing")
        if launches != SIGN_LAUNCHES or plain:
            fail(f"signing B={bsz}: launches {launches}, plain {plain}; "
                 f"want {SIGN_LAUNCHES} and no plain call")
        if bsz == B:
            for name in ("sc_reduce64", "sc_muladd", "compress"):
                rows[name]["launches"] = launches[name]

        args = (gpu(msgs), gpu(lens), gpu(seeds))
        k_sigs, k_pubs = sign.sign_batch(*args)
        p_sigs, p_pubs = sign.sign_batch_ref(*args)
        if not (torch.equal(k_sigs, p_sigs) and torch.equal(k_pubs, p_pubs)):
            fail(f"signing B={bsz}: the kernels' bytes differ from the plain "
                 f"composition on {int((k_sigs != p_sigs).any(1).sum())} "
                 f"lanes")
        got = k_sigs.cpu().numpy()
        if [got[i].tobytes() for i in range(bsz)] != sigs:
            fail(f"signing B={bsz}: sign_jobs differs from sign_batch")
        for i in np.linspace(0, bsz - 1, 64).astype(int):
            if sigs[i] != oracle.sign(*jobs[i]):
                fail(f"signing B={bsz}: lane {i} differs from the oracle")
        say(f"signing B={bsz}: {bsz} signatures equal the plain "
            f"composition's, 64 lanes equal the oracle's")

        vargs = (args[0], args[1], k_sigs, k_pubs)
        entry, _ = registry().acquire(EngineSpec("direct", bsz))
        st = entry.fn(*vargs).cpu().numpy()
        rlc, _ = registry().acquire(EngineSpec("rlc", bsz))
        res = rlc.fn(*vargs)
        st_rlc = np.asarray(res)
        if st.any() or st_rlc.any() or res.used_fallback:
            fail(f"signing B={bsz}: direct statuses "
                 f"{dict(zip(*np.unique(st, return_counts=True)))}, rlc "
                 f"fallback {res.used_fallback}")
        say(f"signing B={bsz}: the signed batch verifies, direct every "
            f"status 0, rlc batch_ok True without fallback")

        ms = time_ms(torch, lambda: sign.sign_batch(*args), TIMED_BATCHES)
        t0 = time.perf_counter()
        for _ in range(TIMED_BATCHES):
            sign.sign_batch(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TIMED_BATCHES
        say(f"sign B={bsz} ({desc}): {ms:.3f} ms/call (CUDA events), "
            f"{bsz / (ms / 1e3):.0f} signatures/s; host clock "
            f"{wall * 1e3:.3f} ms/call, {bsz / wall:.0f} signatures/s "
            f"[{card}]")
        profile_batches(torch, lambda: sign.sign_batch(*args), wall * 1e3)


def rlc_path(torch, gpu, rows, card, batches, expects, direct_b, zcash_pass,
             direct_entry) -> None:
    """Phase 5: the RLC engine in both front halves on the bench, mixed
    and torsion batches."""
    inputs = [tuple(gpu(a) for a in arrs) for arrs in batches]
    torch.cuda.synchronize()
    want_b = expects[1].copy()
    for b in zcash_pass:
        want_b[b] = direct_b[b]
    direct_t = np.asarray(direct_entry.fn(*inputs[2]).cpu())
    for frontend in FRONT_LAUNCHES:
        rlc_front_half(torch, rows, card, inputs, frontend,
                       (expects[0], want_b, direct_b, direct_t))


def rlc_front_half(torch, rows, card, inputs, frontend, wants) -> None:
    """One front half's engine: its launch counts on the three batches
    (reset just before, read just after), statuses, verifies/s, device
    time by kernel and the host clock of the pass's stages."""
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops import backend

    want_a_st, want_b, direct_b, direct_t = wants
    t0 = time.perf_counter()
    entry, warmed = registry().acquire(EngineSpec("rlc", B,
                                                  frontend=frontend))
    say(f"engine {entry.key} on {entry.device}: warmed={warmed} "
        f"in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()

    backend.reset_counts()
    res_a = entry.fn(*inputs[0])
    st_a = np.asarray(res_a)
    counts_a, plain_a = dict(backend.launches), dict(backend.plain_calls)
    res_b = entry.fn(*inputs[1])
    st_b = np.asarray(res_b)
    res_t = entry.fn(*inputs[2])
    st_t = np.asarray(res_t)
    torch.cuda.synchronize()
    launches, plain = dict(backend.launches), dict(backend.plain_calls)
    say(f"rlc path ({frontend}): batch (a) launches {counts_a}; all three "
        f"batches launches {launches}, plain calls {plain}")
    want_a = {**FRONT_LAUNCHES[frontend], **RLC_PASS}
    if counts_a != want_a or plain_a:
        fail(f"rlc batch (a), {frontend}: launches {counts_a}, plain "
             f"{plain_a}; want {want_a} and no plain call")
    if any(plain.values()):
        fail(f"a plain version ran on the rlc path ({frontend}): {plain}")
    # Rows 12 and 13 take their launches from the signing path.
    own = (("sha512_batch",) if frontend == "staged" else
           ("frontend_rlc", *RLC_PASS))
    for name in own:
        for row in TAILS_ROWS if name == "msm_tails" else (name,):
            rows[row]["launches"] = launches[name]

    if res_a.used_fallback or not np.array_equal(st_a, want_a_st):
        fail(f"rlc batch (a), {frontend}: fallback {res_a.used_fallback}, "
             f"statuses {dict(zip(*np.unique(st_a, return_counts=True)))}")
    say(f"rlc batch a bench ({frontend}): batch_ok True, no fallback, {B} "
        f"lanes SUCCESS")
    if (not res_b.used_fallback or not np.array_equal(st_b, want_b)
            or not np.array_equal(st_b, direct_b)):
        fail(f"rlc batch (b), {frontend}: fallback {res_b.used_fallback}, "
             f"{int((st_b != direct_b).sum())} lanes differ from direct")
    say(f"rlc batch b mixed ({frontend}): fallback used, {B} lanes equal "
        f"the direct path's and the constructed statuses")
    if (not res_t.used_fallback or not np.array_equal(st_t, direct_t)
            or not (direct_t[4:10] != 0).all()):
        fail(f"rlc batch (t), {frontend}: fallback {res_t.used_fallback}, "
             f"statuses {st_t[:12].tolist()} vs direct "
             f"{direct_t[:12].tolist()}")
    say(f"rlc batch t torsion ({frontend}): fallback used, lanes 4-9 "
        f"rejected {st_t[4:10].tolist()}, {B} lanes equal the direct "
        f"path's")

    a_args = inputs[0]
    ms = time_ms(torch, lambda: entry.fn(*a_args), TIMED_BATCHES)
    t0 = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        np.asarray(entry.fn(*a_args))
    wall = (time.perf_counter() - t0) / TIMED_BATCHES
    entry.note_service(int(wall * 1e9))
    say(f"verify rlc ({frontend}) B={B} msg={MSG_LEN}: {ms:.3f} ms/batch "
        f"(CUDA events), {B / (ms / 1e3):.0f} verifies/s; host clock with "
        f"the batch_ok read-back {wall * 1e3:.3f} ms/batch, "
        f"{B / wall:.0f} verifies/s [{card}]")
    t0 = time.perf_counter()
    for _ in range(3):
        np.asarray(entry.fn(*inputs[1]))
    wall_b = (time.perf_counter() - t0) / 3
    say(f"verify rlc ({frontend}), batch (b) with its fallback: host clock "
        f"{wall_b * 1e3:.3f} ms/batch, {B / wall_b:.0f} verifies/s")
    profile_batches(torch, lambda: np.asarray(entry.fn(*a_args)), wall * 1e3)
    rlc_stages(torch, a_args, frontend)


def rlc_stages(torch, args, frontend: str, n: int = 5) -> None:
    """Host clock of the stages of a clean RLC pass, each ended by a
    synchronise, so a stage's time holds its host enqueue and its device
    work: drawing z and u (os.urandom) with their copy to the card, the
    front half (decompress_niels, the scalars, glue), the local half
    after it (staging, three fills and aggregations), the tails
    (combine_points: the msm_tails launch, the certification's identity
    test), the verdict (batch_verdict: the T = t1 + t2 identity test in
    plain PyTorch ops) and the batch_ok read-back: the functions the
    engine's pass runs, in its order. Mean of n passes."""
    from firedancer_tpu_torch.ops import verify_rlc as vr

    dev = args[0].device
    names = ("weights", "front half", "fills and aggregations", "tails",
             "verdict", "read-back")
    spent = dict.fromkeys(names, 0.0)
    for _ in range(n):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        z, u = vr.draw_weights(B, dev)
        mark()
        _, _, msm_in = vr.rlc_front(*args, z, u, frontend=frontend)
        mark()
        parts = vr.msm_partials(msm_in)
        mark()
        tails = vr.combine_points(parts)
        mark()
        ok = vr.batch_verdict(*tails)
        mark()
        if not bool(ok):
            fail(f"rlc stages ({frontend}): the clean batch's verdict is "
                 f"False")
        mark()
        for name, a, b in zip(names, marks, marks[1:]):
            spent[name] += (b - a) / n
    total = sum(spent.values())
    say(f"rlc stages ({frontend}), host clock with a synchronise after "
        f"each, mean of {n} clean passes: {total * 1e3:.3f} ms")
    for name, t in spent.items():
        say(f"  {t * 1e3:8.3f} ms {100 * t / total:5.1f}% {name}")


def fill_chain(idx, chunks: int) -> tuple[int, int]:
    """Longest dependent chain of one fill thread, in (madds, unified
    adds): ceil(n / C) madds for the fullest lane of n points, then
    log2 C tree adds."""
    n = int((idx >= 0).sum(dim=-1).max())
    return -(-n // chunks), chunks.bit_length() - 1


def aggregate_chain(nb: int, seg: int) -> tuple[int, int]:
    """Longest dependent chain of one aggregation thread, in (unified
    adds, doublings): 2 (s - 1) segment adds, 5 scan adds, 1 add and 5
    tree adds, and log2 s doublings."""
    return 2 * (seg - 1) + 11, seg.bit_length() - 1


def msm_parity(torch, gpu, parity, record, batch_a, batch_t) -> None:
    """Phase 3, the MSM kernels: each against its plain version at the
    main path's shapes, staged from the clean batch (a) through the RLC
    front half with seeded weights; the fills read the niels forms the
    decompress kernel wrote. The fill and aggregation kernels add in
    their own order: each launch equals its split mirror (*_split_ref)
    limb for limb and the JAX-order plain version (*_ref) as points."""
    from firedancer_tpu_torch import convert, msm_plan
    from firedancer_tpu_torch.ops import curve25519 as ge
    from firedancer_tpu_torch.ops import fe25519 as fe
    from firedancer_tpu_torch.ops import msm, msm_cuda
    from firedancer_tpu_torch.ops import verify_rlc as vr

    rng = np.random.default_rng(11)
    z = gpu(vr.fresh_z(B, rng))
    u = gpu(vr.fresh_u(vr.TORSION_K, 2 * B, rng))
    args = tuple(gpu(a) for a in batch_a)
    _, definite, msm_in = vr.rlc_front(*args, z, u)
    if bool(definite.any()):
        fail("msm parity: the clean batch has definite lanes")
    for name, (_, pts, niels) in msm_in.items():
        parity(f"niels forms of the {name} MSM (kernel vs formed in "
               f"PyTorch)", niels, ge.niels_limbs(pts))
    grids = []
    for name, (scalars, _, niels), nw in (
            ("z", msm_in["r"], msm.WINDOWS_Z),
            ("253", msm_in["m"], msm.WINDOWS_253)):
        rounds = msm_plan.default_rounds(niels.shape[0])
        grids.append((name, niels) + msm._staging_indices(
            scalars, nw, niels.shape[0], rounds))
    u_live, _, niels = msm_in["sub"]
    nb_t = 1 << msm_plan.TORSION_BUCKET_BITS
    grids.append(("torsion", niels) + msm._staging_from_digits(
        u_live & (nb_t - 1), 2 * B, msm_plan.default_rounds(2 * B, nb_t),
        nb_t))

    def kernel_row(name, runs, replaces, source):
        return kernel_pass(torch, parity, record, name, runs, replaces,
                           source)

    def same_points(name, got, want):
        """The same group elements lane by lane: X1 Z2 = X2 Z1 and
        Y1 Z2 = Y2 Z1 on every lane (on the card), and equal affine
        encodings on the first 512."""
        x1, y1, z1 = ge.from_limbs51(got, 3)
        x2, y2, z2 = ge.from_limbs51(want, 3)
        ok = (fe.fe_eq(fe.fe_mul(x1, z2), fe.fe_mul(x2, z1))
              & fe.fe_eq(fe.fe_mul(y1, z2), fe.fe_mul(y2, z1)))
        if not bool(ok.all()):
            fail(f"{name}: {int((~ok).sum())} of {ok.numel()} lanes are "
                 f"other points than the JAX order's")
        parity(f"{name} (affine, 512 lanes)",
               convert.point_to_affine_bytes(got[:512]),
               convert.point_to_affine_bytes(want[:512]))
        say(f"  {name}: {ok.numel()} lanes the same points as the JAX "
            f"order's")

    def fill_sweep(name, pts, idx):
        """The fill at each C of FILL_SWEEP threads a lane, equal to its
        split mirror at that C: the times behind msm_fill.cu's choice of
        C (msm_cuda.fill_chunks)."""
        nw, nb, rounds = idx.shape
        idx_l = idx.reshape(nw * nb, rounds).contiguous()
        times = []
        for c in FILL_SWEEP:
            def kern(c=c):
                return msm_cuda.fill_buckets_cuda(pts, idx_l, chunks=c)
            parity(f"msm_fill {name} at C = {c}", kern(),
                   msm_cuda.fill_buckets_split_ref(pts, idx, chunks=c))
            times.append(f"C = {c} {time_ms(torch, kern, REPS):.4f} ms")
        say(f"  msm_fill {name} by threads a lane (chosen C = "
            f"{msm_cuda.fill_chunks(rounds, nw * nb)}): {', '.join(times)}")

    runs = []
    for name, pts, idx, ok in grids:
        if not bool(ok):
            fail(f"msm_fill {name}: the clean batch overflowed a bucket")
        nw, nb, rounds = idx.shape
        idx_l = idx.reshape(nw * nb, rounds).contiguous()
        chunks = msm_cuda.fill_chunks(rounds, nw * nb)
        madds, adds = fill_chain(idx, chunks)
        say(f"  msm_fill {name}: C = {chunks}, {nw * nb * chunks} threads; "
            f"longest chain {rounds} madds (one thread a lane) -> {madds} "
            f"madds + {adds} adds")
        runs.append((f"{name} {nw}x{nb} lanes x {rounds} rounds",
                     lambda p=pts, i=idx_l: msm_cuda.fill_buckets_cuda(p, i),
                     lambda p=pts, i=idx: msm_cuda.fill_buckets_split_ref(
                         p, i),
                     bound_fill(nw * nb, rounds, int((idx >= 0).sum()),
                                pts.shape[0])))
    fills = kernel_row("msm_fill", runs,
                       "firedancer_tpu/ops/msm_pallas.py:148",
                       "firedancer_tpu_torch/ops/csrc/msm_fill.cu")
    for (name, pts, idx, _), out in zip(grids, fills.values()):
        same_points(f"msm_fill {name}", out,
                    msm_cuda.fill_buckets_ref(pts, idx))
        fill_sweep(name, pts, idx)
    runs, agg_in = [], []
    for (name, _, idx, _), out in zip(grids, fills.values()):
        ncols, nb = idx.shape[:2]
        seg = msm_cuda.aggregate_segment(nb)
        adds, dbls = aggregate_chain(nb, seg)
        say(f"  msm_aggregate {name}: s = {seg}; longest chain "
            f"{2 * (nb - 2)} adds (one thread a column) -> {adds} adds + "
            f"{dbls} doublings")
        buckets = out.reshape(ncols, nb, 4, 5)
        agg_in.append(buckets)
        runs.append((f"{name} {ncols} columns x {nb}",
                     lambda b=buckets: msm_cuda.aggregate_buckets_cuda(b),
                     lambda b=buckets: msm_cuda.aggregate_buckets_split_ref(
                         b),
                     bound_aggregate(ncols, nb)))
    agg_out = kernel_row("msm_aggregate", runs,
                         "firedancer_tpu/ops/msm_pallas.py:353",
                         "firedancer_tpu_torch/ops/csrc/msm_aggregate.cu")
    for run, buckets, got, (_, pts, idx, _) in zip(runs, agg_in,
                                                  agg_out.values(), grids):
        same_points(f"msm_aggregate {run[0]}", got,
                    msm_cuda.aggregate_buckets_ref(buckets))
        idx_l = idx.reshape(-1, idx.shape[2]).contiguous()
        events, traced = after_other(
            torch, lambda p=pts, i=idx_l: msm_cuda.fill_buckets_cuda(p, i),
            run[1], "msm_aggregate_kernel")
        say(f"  msm_aggregate {run[0]}: right after its fill (as in the "
            f"pass), under the profiler: {events:.4f} ms by CUDA events, "
            f"{'not measured' if traced is None else f'{traced:.4f} ms'} "
            f"by the trace")
    aggs = list(agg_out.values())
    trials = aggs[2]
    tails_parity(torch, gpu, parity, record, aggs, batch_t, z, u)
    parts = {"w_r": aggs[0], "ok_r": grids[0][3], "w_m": aggs[1],
             "ok_m": grids[1][3], "sub": trials, "sub_ok": grids[2][3]}
    if not bool(vr.verify_rlc_combine(parts)):
        fail("msm parity: the clean batch's RLC verdict is False")
    say("msm parity: the clean batch's staged MSMs verify (batch_ok True)")

    # Every plan of msm_plan.all_plans() on both MSMs: the fill (the
    # signed plans with the sign folded into the gather, heights 2^w and
    # 2^(w-1) + 1), the aggregation and the Horner (the l3 plans with
    # _top_window_sum's point as their top window, w = 6, 7, 8) against
    # the split mirrors, the JAX order's points and the plain Horner;
    # the tails launch at the plan's w; the whole pass's verdict.
    for plan in msm_plan.all_plans():
        tok = msm_plan.plan_token(plan)
        ws = []
        for name, (scalars, pts, niels), n_windows in (
                ("z", msm_in["r"], msm.WINDOWS_Z),
                ("253", msm_in["m"], msm.WINDOWS_253)):
            idx, neg, ok, top, planes = msm.msm_staging(
                scalars, n_windows, pts.shape[0], plan)
            n_neg = 0 if neg is None else int(neg.sum())
            if not bool(ok) or (plan.signed and n_neg == 0):
                fail(f"msm_fill {tok} {name}: fill verdict {bool(ok)}, "
                     f"{n_neg} negated slots")
            nw, nb, rounds = idx.shape
            label = f"{tok} {name} {nw}x{nb} lanes x {rounds} rounds"
            fill = msm_cuda.fill_buckets(niels, idx, neg)
            parity(f"msm_fill {label}", fill,
                   msm_cuda.fill_buckets_split_ref(niels, idx, neg))
            same_points(f"msm_fill {label}", fill,
                        msm_cuda.fill_buckets_ref(niels, idx, neg))
            buckets = fill.reshape(nw, nb, 4, 5)
            w_res = msm_cuda.aggregate_buckets(buckets)
            parity(f"msm_aggregate {label}", w_res,
                   msm_cuda.aggregate_buckets_split_ref(buckets))
            same_points(f"msm_aggregate {label}", w_res,
                        msm_cuda.aggregate_buckets_ref(buckets))
            if planes:
                w_res = torch.cat([w_res, msm._top_window_sum(top, pts,
                                                              planes)])
            parity(f"msm_horner {tok} {name}, {w_res.shape[0]} windows",
                   msm_cuda.window_horner_cuda(w_res, plan.w),
                   msm_cuda.window_horner_ref(w_res, plan.w))
            ws.append(w_res)
            say(f"  msm plan {tok} {name}: {n_neg} of "
                f"{int((idx >= 0).sum())} slots negated, "
                f"{'a summed top window, ' if planes else ''}"
                f"{w_res.shape[0]} windows of {plan.w} bits")
        parity(f"msm_tails {tok}",
               msm_cuda.msm_tails_cuda(*ws, trials, plan.w),
               msm_cuda.msm_tails_ref(*ws, trials, plan.w))
        if not bool(vr.verify_batch_rlc(*args, z, u, plan=plan)[2]):
            fail(f"msm parity: the clean batch's RLC verdict at {tok} is "
                 f"False")
    say(f"msm parity: at each of the {len(msm_plan.all_plans())} plans "
        f"both MSMs' fills and aggregations equal their split mirrors and "
        f"the JAX order's points, their Horners and the tails launch the "
        f"plain versions, and the clean batch verifies (batch_ok True)")


def horner_chain(nw: int, w_bits: int) -> tuple[int, int]:
    """The Horner's dependent chain: field operations in sequence on one
    thread (a window below the top: w doublings of 4 S + 4 M and a
    unified add of 9 M) and stages on a quad (2 a doubling or add)."""
    return (nw - 1) * (8 * w_bits + 9), (nw - 1) * 2 * (w_bits + 1)


def order_chain(order: int) -> tuple[int, int]:
    """The [L] ladder's chain, counted as horner_chain counts: a doubling
    for each bit below the leading one, an add for each set bit."""
    n_dbl, n_add = order.bit_length() - 1, bin(order).count("1") - 1
    return 8 * n_dbl + 9 * n_add, 2 * (n_dbl + n_add)


def _ladder_edges(torch, trials):
    """(64, 4, 5) limbs for the ladder: the eight torsion points (the
    identity, order 2, 4 and 8) at Z = 1 and at a random Z, the same
    negated (limbs up to 2^52), 16 trial aggregates with p added to
    every limb (limbs up to 2^52), then trial aggregates."""
    from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
    from firedancer_tpu_torch.ops import curve25519 as ge

    p = oracle.P
    rng = np.random.RandomState(13)
    t8 = corpus._order8_point()
    rows = []
    for k in range(8):
        x, y = oracle.scalarmult(k, t8)
        lam = int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1
        for zz in (1, lam):
            rows.append([v * zz % p for v in (x, y, 1, x * y)])
    dev = trials.device
    tors = torch.stack([_limbs51(torch, [r[c] for r in rows], dev)
                        for c in range(4)], dim=1)
    plus_p = trials[:16] + _limbs51(torch, [p], dev)[0]
    return torch.cat([tors, ge.point_neg_limbs(tors), plus_p,
                      trials])[:64].contiguous()


def tails_parity(torch, gpu, parity, record, aggs, batch_t, z, u) -> None:
    """Phase 3, the RLC tails (csrc/msm_tails.cu, a quad of threads a
    chain): both Horners (row msm_horner) and the K = 64 ladder (row
    msm_order) launched alone, then all three in one launch, as the pass
    runs them (msm_tails), each equal to its plain version limb for limb.
    The Horner also at nw = 1, 2 and 130; the ladder also on planted edges at
    K = 1, 7, 9 and 64 and on batch (t)'s trial aggregates, where some
    [L] Agg is a small-order point other than the identity."""
    from firedancer_tpu_torch.ops import curve25519 as ge
    from firedancer_tpu_torch.ops import msm, msm_cuda
    from firedancer_tpu_torch.ops import verify_rlc as vr
    from firedancer_tpu_torch.ops.sc25519 import L

    w_z, w_m, trials = aggs
    wb = msm.W_BITS
    for name, w in (("z", w_z), ("253", w_m)):
        one, quad = horner_chain(w.shape[0], wb)
        say(f"  msm_horner {name}: longest chain {one} field operations "
            f"(one thread) -> {quad} stages (a quad)")
    one, quad = order_chain(L)
    say(f"  msm_order: longest chain {one} field operations (one thread a "
        f"trial) -> {quad} stages (a quad a trial)")
    kernel_pass(torch, parity, record, "msm_horner", [
        (f"{name} {w.shape[0]} windows",
         lambda w=w: msm_cuda.window_horner_cuda(w, wb),
         lambda w=w: msm_cuda.window_horner_ref(w, wb),
         bound_horner(w.shape[0], wb))
        for name, w in (("z", w_z), ("253", w_m))],
        "firedancer_tpu/ops/msm_pallas.py:295",
        "firedancer_tpu_torch/ops/csrc/msm_horner.cu")
    # nw = 1 and 2, and 130 windows: three chunks of cached forms.
    w_long = torch.cat([w_m] * 4)[:130].contiguous()
    for w in (w_z[:1].contiguous(), w_z[:2].contiguous(), w_long):
        parity(f"msm_horner, nw = {w.shape[0]}",
               msm_cuda.window_horner_cuda(w, wb),
               msm_cuda.window_horner_ref(w, wb))
    kernel_pass(torch, parity, record, "msm_order", [(
        f"K = {trials.shape[0]} trials",
        lambda: msm_cuda.mul_by_group_order_cuda(trials),
        lambda: msm_cuda.mul_by_group_order_ref(trials),
        bound_order(trials.shape[0], L))],
        "firedancer_tpu/ops/msm_pallas.py:218",
        "firedancer_tpu_torch/ops/csrc/msm_order.cu")
    edges = _ladder_edges(torch, trials)
    for k in (1, 7, 9, 64):
        parity(f"msm_order edges, K = {k}",
               msm_cuda.mul_by_group_order_cuda(edges[:k].contiguous()),
               msm_cuda.mul_by_group_order_ref(edges[:k]))
    _, _, msm_in_t = vr.rlc_front(*(gpu(a) for a in batch_t), z, u)
    sub_t = vr.msm_partials(msm_in_t)["sub"]
    la_t = msm_cuda.mul_by_group_order_cuda(sub_t)
    parity("msm_order, batch (t)'s trial aggregates", la_t,
           msm_cuda.mul_by_group_order_ref(sub_t))
    hit = ~ge.is_identity_limbs(la_t)
    eight = ge.from_limbs51(la_t)
    for _ in range(3):
        eight = ge.point_double(eight)
    if not bool(hit.any()) or not bool(
            ge.is_identity_limbs(ge.to_limbs51(eight)).all()):
        fail(f"msm_order, batch (t): {int(hit.sum())} trials off the "
             f"identity, [8 L] Agg the identity "
             f"{bool(ge.is_identity_limbs(ge.to_limbs51(eight)).all())}")
    say(f"  msm_order: batch (t)'s {sub_t.shape[0]} trials, {int(hit.sum())}"
        f" with [L] Agg a small-order point other than the identity; the "
        f"edges (torsion points at Z = 1 and Z != 1, negated, limbs + p) "
        f"at K = 1, 7, 9 and 64 equal the plain version")

    def tails():
        return msm_cuda.msm_tails_cuda(w_z, w_m, trials, wb)

    def plain():
        return msm_cuda.msm_tails_ref(w_z, w_m, trials, wb)

    def one_by_one():
        return (msm_cuda.window_horner_cuda(w_z, wb),
                msm_cuda.window_horner_cuda(w_m, wb),
                msm_cuda.mul_by_group_order_cuda(trials))

    parity("msm_tails, the pass's tails in one launch", tails(), plain())
    parity("msm_tails at nw = 1 and 2, K = 9", msm_cuda.msm_tails_cuda(
        w_z[:1].contiguous(), w_m[:2].contiguous(), edges[:9].contiguous(),
        wb), msm_cuda.msm_tails_ref(w_z[:1], w_m[:2], edges[:9], wb))
    bound = _sum_bounds([bound_horner(w_z.shape[0], wb),
                         bound_horner(w_m.shape[0], wb),
                         bound_order(trials.shape[0], L)])
    say(f"  msm_tails, both Horners and K = {trials.shape[0]} ladders in "
        f"one launch: kernel {time_ms(torch, tails, REPS):.4f} ms, the "
        f"three launched one by one {time_ms(torch, one_by_one, REPS):.4f}"
        f" ms, plain {time_ms(torch, plain, 1):.1f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    info = msm_cuda.tails_kernel_info()
    say(f"msm_tails resources: {info['threads']} threads (one warp) a "
        f"block, {info['registers']} registers and {info['stack_bytes']} B"
        f" of stack a thread, {info['static_shared_bytes']} B of shared "
        f"memory a block; ptxas above gives spills")


# ------------------------------------------------------------- tile

def tile_traffic(torch, n: int):
    """The tile phase's corpora, built and signed on the card (dirty:
    the published mix; clean: the same with no duplicate, corrupt or
    truncated traffic), each with the mainnet fixtures at the front,
    and the fixtures' oracle statuses."""
    from firedancer_tpu_torch.ballet.ed25519 import oracle
    from firedancer_tpu_torch.ballet.txn import parse_txn
    from firedancer_tpu_torch.disco import corpus as dcorpus

    fx_dir = os.path.join(REPO, "tests", "fixtures")
    paths = sorted(os.path.join(fx_dir, f) for f in os.listdir(fx_dir)
                   if f.startswith("transaction") and f.endswith(".bin"))
    pack = os.path.join(fx_dir, "txn_pack")
    paths += sorted(os.path.join(pack, f) for f in os.listdir(pack)
                    if f.endswith(".bin"))
    fixtures = [open(f, "rb").read() for f in paths]
    fx_ok = []
    for p in fixtures:
        items = parse_txn(p).verify_items(p)
        fx_ok.append(all(oracle.verify(m, sg, pk) == 0 for sg, pk, m in items))
    out = {}
    for name, rates in (("dirty", {}), ("clean", {
            "dup_rate": 0.0, "corrupt_rate": 0.0, "parse_err_rate": 0.0})):
        t0 = time.perf_counter()
        c = dcorpus.mainnet_corpus(n=n, seed=42, sign_batch_size=TILE_SIGN_B,
                                   **rates)
        torch.cuda.synchronize()
        classes = collections.Counter(int(e) for e in c.expected)
        say(f"tile corpus {name}: {len(c.payloads)} payloads {dict(classes)} "
            f"(0 OK, 1 DUP, 2 BAD_SIG, 3 BAD_PARSE) + {len(fixtures)} "
            f"mainnet fixtures ({sum(fx_ok)} verify by the oracle), built "
            f"and signed on the card in {time.perf_counter() - t0:.1f} s")
        out[name] = c
    return fixtures, fx_ok, out


def tile_want_launches(mode: str, batches: int, fallbacks: int) -> dict:
    """Each kernel's launches in a tile run: a direct batch launches the
    direct rows once; an rlc batch runs the fused pass, and a batch that
    falls back the direct rows once more."""
    if mode == "direct":
        return {k: batches for k in DIRECT_KERNELS}
    want = {k: v * batches for k, v in
            {**FRONT_LAUNCHES["fused"], **RLC_PASS}.items()}
    if fallbacks:
        want.update({k: fallbacks for k in DIRECT_KERNELS})
    return want


# The healing lane's counters that every run but phase 11's must leave at
# 0: a kernel fault that the breaker or the quarantine would absorb fails
# the run instead.
HEALING_ZERO = ("cpu_failover", "quarantined", "breaker_trips",
                "stager_restarts")


def healing_problems(stats) -> list:
    """The nonzero healing counters of each verify tile's record."""
    return [f"verify lane {i}: {k} {vs[k]}" for i, vs in enumerate(stats)
            for k in HEALING_ZERO if vs[k]]


def tile_run(torch, card, label, mode, native_drain, corpus, fixtures,
             fx_ok, batch):
    """One replay -> verify -> sink run on the card: its exact
    accounting, launches, counters and numbers (tile_phase)."""
    import hashlib

    from firedancer_tpu_torch.ballet.txn import MAX_SIG_CNT
    from firedancer_tpu_torch.disco import corpus as dcorpus
    from firedancer_tpu_torch.disco import pipeline, tiles
    from firedancer_tpu_torch.disco.feed.runtime import verify_tile_stats
    from firedancer_tpu_torch.ops import backend
    from firedancer_tpu_torch.tango.rings import Workspace
    from torch.profiler import ProfilerActivity, profile

    payloads = fixtures + corpus.payloads
    path = os.path.join(REPO, "build", "tile_smoke.wksp")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    topo = pipeline.build_topology(path, depth=TILE_DEPTH,
                                   wksp_sz=TILE_WKSP)
    w = Workspace.join(topo.wksp_path)
    try:
        replay = tiles.ReplayTile(w, "replay.cnc",
                                  pipeline.out_link(w, "replay_verify"),
                                  payloads=payloads)
        verify = tiles.VerifyTile(
            w, "verify.cnc", pipeline.in_link(w, "replay_verify"),
            pipeline.out_link(w, "verify_dedup"), backend="gpu",
            batch=batch, inflight=2, tcache_depth=4096, verify_mode=mode,
            native_drain=native_drain)
        sink = tiles.SinkTile(w, "sink.cnc",
                              pipeline.in_link(w, "verify_dedup"),
                              record_digests=True)
        torch.cuda.synchronize()
        backend.reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = pipeline.run_tiles(
                [replay, verify, sink],
                lambda: pipeline.chain_quiesced(replay, verify, sink),
                timeout_s=600.0)
            torch.cuda.synchronize()
        launches, plain = dict(backend.launches), dict(backend.plain_calls)
        sv = verify.cnc.diag(tiles.CNC_DIAG_SV_FILT_CNT)
        ha = verify.cnc.diag(tiles.CNC_DIAG_HA_FILT_CNT)
    finally:
        w.leave()
        os.remove(path)

    v = verify
    cls = collections.Counter(int(e) for e in corpus.expected)
    digests = collections.Counter(sink.digests)
    valid = set(dcorpus.expected_sink_digests(corpus))
    fx_d = [hashlib.sha256(p).digest() for p in fixtures]
    valid |= {d for d, ok in zip(fx_d, fx_ok) if ok}
    bad = {hashlib.sha256(p).digest()
           for p, e in zip(corpus.payloads, corpus.expected)
           if e in (dcorpus.BAD_SIG, dcorpus.BAD_PARSE)}
    sink_dups = sink.recv_cnt - len(digests)
    problems = []
    if set(digests) != valid:
        problems.append(f"sink set differs from the valid set: "
                        f"{len(valid - set(digests))} missing, "
                        f"{len(set(digests) - valid)} unexpected")
    if bad & set(digests):
        problems.append(f"{len(bad & set(digests))} BAD_SIG/BAD_PARSE "
                        "payloads reached the sink")
    if sv != cls[dcorpus.BAD_SIG] + cls[dcorpus.BAD_PARSE]:
        problems.append(f"SV_FILT_CNT {sv} != #BAD_SIG + #BAD_PARSE "
                        f"{cls[dcorpus.BAD_SIG] + cls[dcorpus.BAD_PARSE]}")
    if ha + sink_dups != cls[dcorpus.DUP]:
        problems.append(f"HA_FILT_CNT {ha} + sink duplicates {sink_dups} "
                        f"!= #DUP {cls[dcorpus.DUP]}")
    for d, ok in zip(fx_d, fx_ok):
        if (d in digests) != ok:
            problems.append("a mainnet fixture published against its "
                            "oracle status")
            break
    want = tile_want_launches(mode, v.stat_batches, v.stat_rlc_fallback)
    if launches != want:
        problems.append(f"launches {launches} != batches x rows {want}")
    if plain:
        problems.append(f"plain versions ran: {plain}")
    # A full flush leaves no room for the next txn (at most MAX_SIG_CNT
    # lanes); a deadline, starved, ring or halt flush is partial.
    misfiled = [(lanes, verdict) for lanes, verdict in v.batch_log
                if (lanes <= batch - MAX_SIG_CNT
                    if verdict == tiles.FLUSH_FULL
                    else lanes >= batch)]
    if misfiled:
        problems.append(f"{len(misfiled)} batches flushed under a verdict "
                        f"their fill contradicts, first {misfiled[0]}")
    if label.startswith("4") and v.stat_rlc_fallback:
        problems.append(f"{v.stat_rlc_fallback} RLC fallbacks on the clean "
                        "corpus")
    problems += healing_problems([verify_tile_stats(v)])

    span = (sink.t_last - replay.pub_ticks[0]) / 1e9
    lat = tiles.latencies_ns(replay, sink).astype(np.float64) / 1e6
    busy, kernels = trace_busy(prof)
    share = (f"device busy {busy * 1e3:.1f} ms of {span * 1e3:.1f} = "
             f"{100 * busy / span:.1f}%, idle {100 - 100 * busy / span:.1f}% "
             f"({kernels} device operations, torch.profiler)"
             if busy > 0 else "device busy share not measured (the trace "
             "shows no device time)")
    say(f"tile run {label}: {len(payloads)} txns in {span:.3f} s from the "
        f"first publish to the last sink frag = {len(payloads) / span:.0f} "
        f"txn/s, {v.stat_lanes} signature lanes = "
        f"{v.stat_lanes / span:.0f} lanes/s (host clock; run_tiles "
        f"{wall:.3f} s) [{card}]")
    say(f"tile run {label}: sink {sink.recv_cnt} frags ({len(digests)} "
        f"distinct, {sink_dups} duplicates past the HA filter), latency "
        f"p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms over {len(lat)} samples; "
        f"SV_FILT {sv}, HA_FILT {ha} [{card}]")
    say(f"tile run {label}: host CPU by thread (thread_time) replay "
        f"{replay.cpu_ns / 1e9:.3f} s, verify {v.cpu_ns / 1e9:.3f} s (engine "
        f"calls {v.stat_dispatch_ns / 1e9:.3f} s, completions with their "
        f"publishes {v.stat_complete_ns / 1e9:.3f} s, wall), sink "
        f"{sink.cpu_ns / 1e9:.3f} s, of {wall:.3f} s of wall [{card}]")
    say(f"tile run {label}: {v.stat_batches} batches of B={batch}, fill "
        f"{v.stat_lanes / max(1, v.stat_batches * batch):.4f}, flushes "
        f"{v.stat_flush}, inflight stalls {v.stat_inflight_stall}, RLC "
        f"fallbacks {v.stat_rlc_fallback}; launches {launches}, plain "
        f"{plain}; "
        f"{share} [{card}]")
    if problems:
        fail(f"tile run {label}: " + "; ".join(problems))
    say(f"tile run {label}: accounting exact, launches = batches x rows, "
        f"no plain call, every flush verdict matches its fill")


def tile_phase(torch, card, n: int = TILE_N, batch: int = B):
    """Phase 7: the verify tile on the card, replay -> verify -> sink,
    in four runs (direct and rlc fused with the native drain, direct
    frag by frag, rlc fused on the clean corpus). Returns the fixtures,
    their oracle statuses and the dirty corpus, phase 8's traffic."""
    fixtures, fx_ok, corpora = tile_traffic(torch, n)
    traffic = (fixtures, fx_ok, corpora["dirty"])
    for label, mode, nd, name in (
            ("1 direct, native drain", "direct", True, "dirty"),
            ("2 rlc fused, native drain", "rlc", True, "dirty"),
            ("3 direct, per-frag Python path", "direct", False, "dirty"),
            ("4 rlc fused, clean corpus", "rlc", True, "clean")):
        tile_run(torch, card, label, mode, nd, corpora[name], fixtures,
                 fx_ok, batch)
    return traffic


# ------------------------------------------------------------- pack

def synthetic_blocks(n: int) -> dict:
    """Phase 8's blocks of n PackTxns that need no corpus: conflict-heavy
    (256 accounts, up to 4 writes and 4 reads a txn,
    tests/test_pack_gc.py's _mk_txns), wide (15-35 writes and 15-35
    reads a txn over 512 accounts, 128 of them four to a bucket at
    PACK_H, so that rows pass the record's 29 head slots and repeat
    buckets), disjoint (one account a txn), capped by CUs (1-9 M a
    txn), equal scores (the conflict-heavy locks, one score), and
    padding."""
    import random

    from firedancer_tpu_torch.ballet.pack import PackTxn
    from firedancer_tpu_torch.ops.pack_gc import PackTxnPad, hash_accounts

    rng = random.Random(0)
    keys = [bytes([i % 256]) * 4 + i.to_bytes(4, "little") + bytes(24)
            for i in range(256)]
    conflict = []
    for i in range(n):
        w = frozenset(rng.sample(keys, rng.randint(1, 4)))
        r = frozenset(k for k in rng.sample(keys, rng.randint(0, 4))
                      if k not in w)
        conflict.append(PackTxn(i, rng.randint(1_000, 2_000_000),
                                rng.randint(10_000, 1_400_000), w, r))

    cand = [b"wide" + i.to_bytes(8, "little") + bytes(20)
            for i in range(4 * PACK_H)]
    by_bucket = {}
    for k, b in zip(cand, hash_accounts(cand, PACK_H).tolist()):
        by_bucket.setdefault(b, []).append(k)
    shared = [ks[:4] for ks in by_bucket.values() if len(ks) >= 4][:32]
    pool = [k for ks in shared for k in ks]
    taken = set(pool)
    pool += [k for k in cand if k not in taken][:512 - len(pool)]
    wide = []
    for i in range(n):
        w = rng.sample(pool, rng.randint(15, 35))
        ws = set(w)
        r = rng.sample([k for k in pool if k not in ws], rng.randint(15, 35))
        wide.append(PackTxn(i, rng.randint(1_000, 2_000_000),
                            rng.randint(10_000, 400_000), frozenset(w),
                            frozenset(r)))

    def own(i):
        return frozenset({i.to_bytes(4, "little") + bytes(28)})

    return {
        "conflict": conflict,
        "wide": wide,
        "disjoint": [PackTxn(i, 1000 + i, 1000, own(i), frozenset())
                     for i in range(n)],
        "cu_cap": [PackTxn(i, rng.randint(1_000, 9_000), rng.randint(
            1_000_000, 9_000_000), own(i), frozenset()) for i in range(n)],
        "equal_scores": [PackTxn(t.txn_id, 1000, 1000, t.writable,
                                 t.readonly) for t in conflict],
        "padding": [PackTxnPad] * n,
    }


def pack_blocks(fixtures, corpus) -> dict:
    """Phase 8's blocks, each of PACK_N[-1] PackTxns: (m)'s mainnet mix
    (the fixtures and the corpus's unique valid txns as the pack tile
    sees them), then synthetic_blocks."""
    from firedancer_tpu_torch.ballet.pack import CuEstimator
    from firedancer_tpu_torch.disco import corpus as dcorpus
    from firedancer_tpu_torch.disco.tiles import pack_txn

    n = PACK_N[-1]
    est = CuEstimator()
    valid = fixtures + [p for p, e in zip(corpus.payloads, corpus.expected)
                        if e == dcorpus.OK]
    mainnet = []
    for p in valid:
        t = pack_txn(p, len(mainnet), est)
        if t is not None:
            mainnet.append(t)
        if len(mainnet) == n:
            break
    return {"mainnet": mainnet, **synthetic_blocks(n)}


def bench_block(n: int = PACK_BENCH_N) -> list:
    """bench.py pack_worker's block (bench.py:341-350) of the port's
    PackTxns: n txns over PACK_BENCH_ACCTS accounts, random.Random(7),
    1-3 writes and 0-3 reads a txn."""
    import random

    from firedancer_tpu_torch.ballet.pack import PackTxn

    rng = random.Random(PACK_BENCH_SEED)
    keys = [i.to_bytes(8, "little") + bytes(24)
            for i in range(PACK_BENCH_ACCTS)]
    txns = []
    for i in range(n):
        w = frozenset(rng.sample(keys, rng.randint(1, 3)))
        r = frozenset(k for k in rng.sample(keys, rng.randint(0, 3))
                      if k not in w)
        txns.append(PackTxn(txn_id=i, rewards=rng.randint(1_000, 2_000_000),
                            est_cus=rng.randint(10_000, 1_400_000),
                            writable=w, readonly=r))
    return txns


def ptxas_entries(build, name: str) -> list:
    """(entry function, registers, stack, spill stores, spill loads) of
    each kernel of a library, from nvcc -Xptxas -v."""
    out, fn, frame = [], None, None
    for ln in build.ptxas_report().get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out.append((fn, int(m.group(1)), *(frame or (-1, -1, -1))))
            fn = frame = None
    return out


def pack_device_ms(torch, fn, reps: int = REPS) -> dict:
    """Device ms a call of pack_schedule_cuda by kernel (the trace's mean
    a launch; a call launches each once), over reps warm calls of fn:
    {"compact": ..., "scan": ...}, each None when the trace shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for part in ("compact", "scan"):
        total, count = trace_kernels_ms(prof, f"pack_{part}_kernel")
        out[part] = total / count if count and total > 0 else None
    return out


def bound_pack_schedule(w_idx: np.ndarray, r_idx: np.ndarray):
    """Bytes: the buckets, scores and CUs read once, the colors written
    once. Operations, as this block's buckets need them: each step
    tests each color against each valid write bucket twice (both sets)
    and each read bucket once, and its CU sum, then sets the chosen
    color's bits and adds its CUs."""
    n = w_idx.shape[0]
    w = (w_idx >= 0).sum(axis=1).astype(np.int64)
    r = (r_idx >= 0).sum(axis=1).astype(np.int64)
    ops = int((PACK_C * (2 * w + r + 1) + w + r + 1).sum())
    nbytes = w_idx.nbytes + r_idx.nbytes + 3 * 4 * n
    return _bound(ops, nbytes)


def pack_kernel_phase(torch, record, blocks) -> None:
    """Phase 8 (a): pack_schedule_cuda against pack_schedule_ref on the
    same CUDA tensors, lane for lane, on every block at every PACK_N and
    on the conflict-heavy and wide blocks at PACK_K_N for each PACK_K,
    and on the bench block at PACK_BENCH_EQ; times of the mainnet block
    at PACK_TIMED, the padding block and the bench block at PACK_BENCH_N
    (CUDA events, which include the wrapper's sort and allocations, and
    the trace's device time of both launches), ns a step, the chain's
    floor (pack_chain_floor: one warp's step skeleton) and the plain
    version."""
    from firedancer_tpu_torch.ballet.pack import validate_schedule
    from firedancer_tpu_torch.ops import build, pack_gc, pack_gc_cuda

    dev = torch.device("cuda", 0)
    kw = {"n_colors": PACK_C, "h_bits": PACK_H, "cu_cap": PACK_CAP}
    bkw = {**kw, "h_bits": PACK_BENCH_H}

    def tensors(txns, h_bits=PACK_H, width=PACK_A):
        arrs = pack_gc.build_arrays(txns, h_bits, max_w=width, max_r=width)
        return arrs, [torch.from_numpy(a).to(dev) for a in arrs]

    def equal(label, args, params):
        got = pack_gc_cuda.pack_schedule_cuda(*args, **params)
        want = pack_gc.pack_schedule_ref(*args, **params)
        if not torch.equal(got, want):
            fail(f"pack_schedule {label}: {int((got != want).sum())} lanes "
                 f"differ from the plain version")
        return (max_abs_err(torch, got, want),
                f"{int((got >= 0).sum())} colored, {int(got.max()) + 1} waves")

    err = 0.0
    for name, txns in blocks.items():
        summary = []
        for n in PACK_N:
            _, args = tensors(txns[:n])
            e, note = equal(f"{name} n={n}", args, kw)
            err = max(err, e)
            summary.append(f"n={n}: {note}")
        say(f"pack_schedule {name}: equal at every n ({'; '.join(summary)})")
    # The wide block must reach the records' overflow words (more than
    # 29 valid buckets, and past 61, where the lanes loop twice) and
    # repeat buckets within a row.
    arrs, _ = tensors(blocks["wide"])
    rows = np.concatenate(arrs[:2], axis=1)
    cnt = (rows >= 0).sum(axis=1)
    rep = sum(len(set(r[r >= 0].tolist())) < c for r, c in zip(rows, cnt))
    say(f"pack_schedule wide: {int((cnt > 29).sum())} of {len(cnt)} rows "
        f"past 29 valid buckets, {int((cnt > 61).sum())} past 61, "
        f"{rep} with a repeated bucket, at most {int(cnt.max())}")
    if not ((cnt > 61).any() and rep):
        fail("pack_schedule wide: the block misses the records' overflow "
             "or a repeated bucket")
    for c, h in PACK_K:
        notes = []
        for name in ("conflict", "wide"):
            _, args = tensors(blocks[name][:PACK_K_N], h)
            e, note = equal(f"{name} C={c} H={h} n={PACK_K_N}", args,
                            {**kw, "n_colors": c, "h_bits": h})
            err = max(err, e)
            notes.append(f"{name}: {note}")
        say(f"pack_schedule C={c} H={h}: equal at n={PACK_K_N} "
            f"({'; '.join(notes)})")
    bench = bench_block()
    # build_arrays' default widths, as schedule_block gives pack_worker.
    _, bargs = tensors(bench[:PACK_BENCH_EQ], PACK_BENCH_H, None)
    e, note = equal(f"bench n={PACK_BENCH_EQ}", bargs, bkw)
    err = max(err, e)
    say(f"pack_schedule bench (pack_worker's block, H = {PACK_BENCH_H}): "
        f"equal at n={PACK_BENCH_EQ} ({note})")
    threads, pre_blocks, pre_threads, smem = pack_gc_cuda.geometry(
        PACK_C, PACK_H, B)
    say(f"pack_schedule resources at n={B}: the compaction in {pre_blocks} "
        f"blocks of {pre_threads} threads, the scan in one block of "
        f"{threads} threads with {smem} B of dynamic shared memory "
        f"({pack_gc_cuda.geometry(PACK_C, PACK_BENCH_H, 1)[3]} B at "
        f"H = {PACK_BENCH_H})")
    for fn, regs, stack, sp_st, sp_ld in ptxas_entries(build, "pack_gc"):
        say(f"  ptxas {fn}: {regs} registers, {stack} B stack, spills "
            f"{sp_st} / {sp_ld} B")

    def timed(label, n, args, params, plain=False):
        def kern():
            return pack_gc_cuda.pack_schedule_cuda(*args, **params)

        k_ms = time_ms(torch, kern, REPS)
        parts = pack_device_ms(torch, kern)
        dev_ms = (None if None in parts.values()
                  else parts["compact"] + parts["scan"])
        floor = pack_gc_cuda.chain_floor_ms(n, dev)
        p_ms = (time_ms(torch, lambda: pack_gc.pack_schedule_ref(
            *args, **params), 1) if plain else None)
        dev_s = ("not measured" if dev_ms is None else
                 f"{dev_ms:.4f} ms (compaction {parts['compact']:.4f}, scan "
                 f"{parts['scan']:.4f}; {1e6 * parts['scan'] / n:.1f} ns a "
                 f"step)")
        plain_s = "" if p_ms is None else f", plain {p_ms:.1f} ms"
        say(f"  pack_schedule {label} n={n}: kernel {k_ms:.4f} ms (CUDA "
            f"events, with the sort), device {dev_s} (trace); chain floor "
            f"{floor:.4f} ms ({1e6 * floor / n:.1f} ns a step: one warp's "
            f"store, __syncwarp, load, REDUX){plain_s}")
        return k_ms, p_ms

    row_ms = row_plain = row_bound = None
    for n in PACK_TIMED:
        arrs, args = tensors(blocks["mainnet"][:n])
        k_ms, p_ms = timed("mainnet", n, args, kw, plain=n == PACK_TIMED[0])
        bound = bound_pack_schedule(arrs[0], arrs[1])
        say(f"  pack_schedule mainnet n={n}: bound {bound[0]:.6f} ms "
            f"({bound[1]})")
        if n == PACK_TIMED[0]:
            row_ms, row_plain, row_bound = k_ms, p_ms, bound
    # The step with no bucket to test (every column -1): the row loads,
    # the CU ballot, the color choice and the warp's exchanges alone.
    _, args = tensors(blocks["padding"][:PACK_TIMED[0]])
    timed("padding", PACK_TIMED[0], args, kw)
    _, bargs = tensors(bench, PACK_BENCH_H, None)
    timed("bench", PACK_BENCH_N, bargs, bkw)
    waves, _ = pack_gc.schedule_block(bench, n_colors=PACK_C,
                                      h_bits=PACK_BENCH_H)
    if not validate_schedule(waves):
        fail("pack_schedule bench: its waves fail validate_schedule")
    say(f"  pack_schedule bench n={PACK_BENCH_N}: {len(waves)} waves, "
        f"{sum(map(len, waves))} txns scheduled, validate_schedule passes")
    record("pack_schedule", err, row_ms, row_plain, row_bound,
           "firedancer_tpu/ops/pack_gc.py:64",
           "firedancer_tpu_torch/ops/csrc/pack_gc.cu")


def bound_dedup_filter(n: int, h_bits: int):
    """The pre-filter's least time. Bytes: each lane reads 8 B of tags
    and 1 B of valid and writes 1 B of verdict; banks A and B are read
    once and the new bank A written once (h_bits / 8 B each); the count
    is 4 B. Operations: the bucket mix, about 10 integer operations a
    lane, far below the bytes' time."""
    return _bound(10 * n, 10 * n + 3 * h_bits // 8 + 4)


def _np_bucket(tags: np.ndarray, h_bits: int) -> np.ndarray:
    """The filter's bucket of each uint64 tag, on the host (the mix of
    ops/dedup_filter.py in uint64 with 32-bit masks)."""
    m = np.uint64(0xFFFFFFFF)
    t = np.asarray(tags, np.uint64)
    hi, lo = t >> np.uint64(32), t & m
    with np.errstate(over="ignore"):
        mix = lo ^ ((hi * np.uint64(0x9E3779B1)) & m)
        mix = ((mix ^ (mix >> np.uint64(15))) * np.uint64(0x85EBCA77)) & m
    mix ^= mix >> np.uint64(13)
    return (mix & np.uint64(h_bits - 1)).astype(np.int64)


def colliders(h_bits: int) -> dict:
    """bucket -> the least small tag (hi = 0) in it, over 8 h_bits tags."""
    cand = np.arange(1, 1 + 8 * h_bits, dtype=np.uint64)
    uniq, first = np.unique(_np_bucket(cand, h_bits), return_index=True)
    return dict(zip(uniq.tolist(), cand[first].tolist()))


def drain_cases(tags_all: np.ndarray, n: int, h_bits: int, rng,
                by_bucket: dict):
    """The pre-filter's planted inputs at n lanes and an h_bits window:
    [(label, tags uint64, valid, bits_a, bits_b int32)]. "corpus": n meta
    sigs of the feed corpus (its duplicates among them), empty banks;
    "planted": the same with in-batch repeats, 5 % invalid lanes in the
    middle, the all-ones tag before and after an invalid lane, pairs of
    distinct tags forced into one bucket (by_bucket: colliders(h_bits))
    and random sparse banks; "invalid prefix": the first quarter invalid, an
    all-ones tag after it."""
    w = h_bits // 32
    zeros = np.zeros(w, np.int32)
    base = tags_all[:n].copy()
    out = [("corpus", base, np.ones(n, np.bool_), zeros, zeros)]
    tags = base.copy()
    valid = np.ones(n, np.bool_)
    q = n // 8
    tags[n // 2:n // 2 + q] = tags[:q]
    valid[rng.rand(n) < 0.05] = False
    ones = [i for i in (0, n // 3, n // 3 + 2, n - 1) if i < n]
    tags[ones] = np.uint64(ALL_ONES)
    if n > 4:
        valid[n // 3 + 1] = False
        valid[ones] = True
    # Colliders: small tags (hi = 0) in the bucket of a chosen lane.
    pairs = [i for i in np.linspace(1, n - 2, 8).astype(int).tolist()
             if 0 < i < n - 1 and i not in ones and i + 1 not in ones]
    for i in pairs:
        c = by_bucket.get(int(_np_bucket(tags[i:i + 1], h_bits)[0]))
        if c is not None and c != int(tags[i]):
            tags[i + 1] = np.uint64(c)
    sparse = [(rng.randint(0, 2 ** 32, w, dtype=np.uint64)
               & rng.randint(0, 2 ** 32, w, dtype=np.uint64)
               & rng.randint(0, 2 ** 32, w, dtype=np.uint64))
              .astype(np.uint32).view(np.int32) for _ in range(2)]
    out.append(("planted", tags, valid, *sparse))
    prefix = np.ones(n, np.bool_)
    prefix[:n // 4] = False
    pt = base.copy()
    pt[n - 1] = np.uint64(ALL_ONES)
    out.append(("invalid prefix", pt, prefix, zeros, zeros))
    return out


def drain_kernel_phase(torch, record, tags_all: np.ndarray,
                       batch: int = B, device="cuda") -> None:
    """Phase 3's dedup_filter (run once phase 9's corpus exists, whose
    meta sigs it filters): dedup_filter.cu against dedup_filter_ref on
    the same CUDA tensors, equal outputs and inputs left as they were, at
    every (n, h_bits) of DRAIN_N x DRAIN_H and DRAIN_WIDE on drain_cases
    (both launches, the one block and the grid), then DRAIN_ROUNDS chained
    rounds of B lanes with a rotation halfway (the corpus's tags in
    order, wrapping to its start), and DRAIN_MAIN lanes of each round
    through the one block; a window that is not a power of two refused
    before any launch; ptxas's registers, stack and spills (none
    allowed) beside each shape's geometry. Times (CUDA events and the
    trace, which must hold 90 % of the launches): the main path's
    DRAIN_MAIN staged lanes, n = 1 (the one block's fixed cost), both
    launches at ONE_CTA_LANES and twice that, the parent's launch (the
    grid on all B lanes at the least table, as the tile called it before)
    at DRAIN_MAIN of B lanes valid, and the wrapper at B and at 65536
    lanes and 2^20 bits; the one block must show one device operation a
    call and the grid four."""
    from firedancer_tpu_torch.ops import backend, build
    from firedancer_tpu_torch.ops import dedup_filter as df
    from firedancer_tpu_torch.ops import dedup_filter_cuda as dfc

    dedup_filter_cuda = dfc.dedup_filter_cuda
    dev = torch.device(device)
    rng = np.random.RandomState(17)
    # The corpus's tags, then seeded random ones up to the widest shape.
    wide_n = max(n for n, _ in DRAIN_WIDE)
    if len(tags_all) < wide_n:
        k = wide_n - len(tags_all)
        extra = (rng.randint(0, 2 ** 63, k, dtype=np.int64).astype(np.uint64)
                 | rng.randint(0, 2, k).astype(np.uint64) << np.uint64(63))
        tags_wide = np.concatenate([tags_all, extra])
    else:
        tags_wide = tags_all

    def up(*arrs):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrs)

    def lanes_up(tags, valid):
        return up(*df.split_tags(tags), valid)

    err = 0.0

    def check(label, args):
        nonlocal err
        keep = (args[3].clone(), args[4].clone())
        got = dedup_filter_cuda(*args)
        want = df.dedup_filter_ref(*args)
        for part, g, w in zip(("novel", "bank A", "count"), got, want):
            e = max_abs_err(torch, g, w)
            err = max(err, e)
            if e != 0 or g.dtype != w.dtype or g.shape != w.shape:
                fail(f"dedup_filter {label}: {part} differs from the plain "
                     f"version (max_abs_err {e})")
        if not (torch.equal(keep[0], args[3])
                and torch.equal(keep[1], args[4])):
            fail(f"dedup_filter {label}: the kernel wrote an input bank")
        return got

    shapes = [(n, h) for n in DRAIN_N for h in DRAIN_H] + list(DRAIN_WIDE)
    # A 2^23-bit window plants no colliders: their table would take
    # 8 x 2^23 candidate tags.
    by_bucket = {h: colliders(h) if h <= 1 << 20 else {} for _, h in shapes}
    checked = []
    for n, h_bits in shapes:
        for label, tags, valid, *banks in drain_cases(
                tags_wide, n, h_bits, rng, by_bucket[h_bits]):
            got = check(f"{label}, n = {n}, h_bits = {h_bits}",
                        lanes_up(tags, valid) + up(*banks))
            checked.append((n, h_bits, label, int(got[2])))
    routes = collections.Counter(dfc.geometry(n, h)[0] for n, h in shapes)
    say("dedup_filter: equal to the plain version (novel, bank A, count; "
        "inputs unchanged) on " + "; ".join(
            f"{lab} n={n} h={h.bit_length() - 1} "
            f"{dfc.geometry(n, h)[0]} novel {c}" for n, h, lab, c in checked
            if (n, h) in DRAIN_WIDE or n in (DRAIN_MAIN, B - 1)) +
        f"; and at n = {', '.join(map(str, DRAIN_N))} x h_bits 2^10, 2^17, "
        f"2^20 ({routes['block']} shapes on the one block, "
        f"{routes['grid']} on the grid)")
    if set(routes) != {"block", "grid"}:
        fail(f"dedup_filter: the parity shapes ran one launch only: {routes}")
    # A window that is not a power of two: ValueError before any launch.
    before = dict(backend.launches)
    bad = lanes_up(tags_wide[:8], np.ones(8, np.bool_)) + up(
        np.zeros(3, np.int32), np.zeros(3, np.int32))
    try:
        dedup_filter_cuda(*bad)
        fail("dedup_filter: a window of 3 words launched")
    except ValueError as e:
        if dict(backend.launches) != before:
            fail("dedup_filter: the refused shape counted a launch")
        say(f"dedup_filter refuses a window of 3 words before any launch: "
            f"{e}")
    # Chained rounds: bank A carried on the device, both chains rotating
    # after round DRAIN_ROUNDS / 2; all B lanes on the grid, then the
    # round's first DRAIN_MAIN lanes on the one block.
    counts = {}
    for n in (batch, DRAIN_MAIN):
        k_banks = r_banks = df.empty_banks(df.DEFAULT_FILTER_BITS, dev)
        counts[n] = []
        for r in range(DRAIN_ROUNDS):
            # Past the corpus's end the rounds wrap to its start: tags the
            # window saw rounds before, across the rotation.
            tags = tags_all[np.arange(r * batch, r * batch + n)
                            % len(tags_all)]
            lanes = lanes_up(tags, rng.rand(n) > 0.03)
            got = dedup_filter_cuda(*lanes, *k_banks)
            want = df.dedup_filter_ref(*lanes, *r_banks)
            e = max_abs_err(torch, got, want)
            err = max(err, e)
            if e != 0:
                fail(f"dedup_filter: chained round {r} of {n} lanes differs "
                     f"from the plain version (max_abs_err {e})")
            counts[n].append(int(got[2]))
            k_banks, r_banks = (got[1], k_banks[1]), (want[1], r_banks[1])
            if r == DRAIN_ROUNDS // 2 - 1:
                k_banks = (torch.zeros_like(got[1]), got[1])
                r_banks = (torch.zeros_like(want[1]), want[1])
    say(f"dedup_filter: {DRAIN_ROUNDS} chained rounds (bank A carried, a "
        f"rotation after round {DRAIN_ROUNDS // 2}) equal; novel counts "
        + "; ".join(f"{n} lanes ({dfc.geometry(n, df.DEFAULT_FILTER_BITS)[0]}"
                    f") {c}" for n, c in counts.items()))
    check_no_stack(build, "dedup_filter")
    say("dedup_filter geometry (route, threads a block, dynamic shared "
        "bytes, table slots): " + "; ".join(
            f"n = {n}, h_bits = 2^{h.bit_length() - 1}: {dfc.geometry(n, h)}"
            for n, h in ((1, df.DEFAULT_FILTER_BITS),
                         (DRAIN_MAIN, df.DEFAULT_FILTER_BITS),
                         (batch, df.DEFAULT_FILTER_BITS),
                         (DRAIN_N[-1], DRAIN_H[-1]), *DRAIN_WIDE)))

    def timed_call(label, fn, route, n, h_bits, plain=None):
        """Say the call's CUDA-event and traced device time; the trace must
        hold every launch and the route's device operations a call."""
        kernels, want_ops = (1, 1) if route == "block" else (2, 4)
        ms = time_ms(torch, fn, REPS)
        dev_ms, ops, held, ok = traced_call_ms(torch, fn, "dedup_", kernels,
                                               want_ops)
        if not ok and max(held) >= 0.9 * kernels * REPS:
            fail(f"dedup_filter {label}: a trace held the launches, but "
                 f"not {want_ops} device operations a call (launches "
                 f"held {held})")
        if not ok:
            # Every trace lost launches: the measurement failed, not the
            # kernel (its parity is checked above).
            say(f"  dedup_filter {label}: every trace lost launches (held "
                f"{held} of {kernels * REPS}): device time not measured")
        plain_ms = time_ms(torch, plain, 2) if plain is not None else None
        bound = bound_dedup_filter(n, h_bits)
        plain_txt = f", plain {plain_ms:.3f} ms" if plain is not None else ""
        say(f"  dedup_filter {label} ({route}): {ms:.4f} ms (CUDA events), "
            f"device {dev_ms:.4f} ms in {ops:g} operations a call (trace, "
            f"launches held {'/'.join(map(str, held))} of "
            f"{kernels * REPS}){plain_txt}, bound {bound[0]:.6f} ms "
            f"({bound[1]})")
        return ms, dev_ms, plain_ms, bound

    def case_args(n, h_bits, n_lanes=None):
        """drain_cases' corpus case at n lanes, valid on the first n of
        n_lanes lanes (n_lanes = n unless given)."""
        n_lanes = n if n_lanes is None else n_lanes
        _, tags, _, *banks = drain_cases(tags_wide, n_lanes, h_bits, rng,
                                         by_bucket[h_bits])[0]
        valid = np.arange(n_lanes) < n
        return lanes_up(tags, valid) + up(*banks)

    def forced(args, route, slots):
        """The library's launch of route on args, as the wrapper makes it
        but at a given table size, outside the wrapper's count."""
        hi, lo, valid, a, b = args
        n, w = hi.shape[0], a.shape[0]
        scr_words = dfc.scratch_words(n, route, slots)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr, cint = ctypes.c_void_p, ctypes.c_int
        if route == "block":
            fn = build.bind("dedup_filter", "fd_dedup_filter_block",
                            [ptr] * 8 + [cint] * 4 + [ptr])
            tail = (n, w, slots, dfc.smem_bytes(n, 32 * w, slots), stream)
        else:
            fn = build.bind("dedup_filter", "fd_dedup_filter_grid",
                            [ptr] * 9 + [cint] * 3 + [ptr])
            tail = (n, w, slots, stream)

        def call():
            _, novel, bits_out, cnt, scr = dfc.outputs(n, w, dev, scr_words)
            ptrs = (hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                    a.data_ptr(), b.data_ptr(), novel.data_ptr(),
                    bits_out.data_ptr(), cnt.data_ptr())
            if route == "grid":
                ptrs += (scr.data_ptr(),)
            build.check_rc(f"fd_dedup_filter_{route}", fn(*ptrs, *tail))
            return novel, bits_out, cnt

        want = df.dedup_filter_ref(*args)
        if max_abs_err(torch, call(), want) != 0:
            fail(f"dedup_filter: the forced {route} launch at n = {n}, "
                 f"{slots} slots differs from the plain version")
        return call

    h17 = df.DEFAULT_FILTER_BITS
    times = {}
    for label, n, h_bits in (("main path, the staged lanes", DRAIN_MAIN,
                              h17),
                             ("n = 1, the fixed cost", 1, h17),
                             ("a full batch", batch, h17),
                             ("the widest timed", DRAIN_N[-1], DRAIN_H[-1])):
        args = case_args(n, h_bits)

        def kern():
            return dedup_filter_cuda(*args)

        route = dfc.geometry(n, h_bits)[0]
        times[label] = timed_call(
            f"{label}, n = {n}, h_bits = 2^{h_bits.bit_length() - 1}", kern,
            route, n, h_bits, lambda: df.dedup_filter_ref(*args))
    # The geometry's choices against their alternatives: the one block's
    # table on the main path; both launches on each side of
    # ONE_CTA_LANES, at the table the wrapper would give each; the grid's
    # table on a full batch.
    def block_slots(n):
        least = slots = dfc.table_slots(n)
        while (slots < dfc.TABLE_GROWTH * least and dfc.smem_bytes(
                n, h17, 2 * slots) <= dfc.SMEM_LIMIT):
            slots *= 2
        return slots

    least = dfc.table_slots
    for n, route, slots in (
            (DRAIN_MAIN, "block", least(DRAIN_MAIN)),
            (DRAIN_MAIN, "block", 2 * least(DRAIN_MAIN)),
            (DRAIN_MAIN, "block", 4 * least(DRAIN_MAIN)),
            (dfc.ONE_CTA_LANES, "block", block_slots(dfc.ONE_CTA_LANES)),
            (dfc.ONE_CTA_LANES, "grid",
             dfc.TABLE_GROWTH * least(dfc.ONE_CTA_LANES)),
            (2 * dfc.ONE_CTA_LANES, "block",
             block_slots(2 * dfc.ONE_CTA_LANES)),
            (2 * dfc.ONE_CTA_LANES, "grid",
             dfc.TABLE_GROWTH * least(2 * dfc.ONE_CTA_LANES)),
            (batch, "grid", least(batch)),
            (batch, "grid", 4 * least(batch))):
        timed_call(f"{route} forced, n = {n}, {slots} slots "
                   f"({slots // least(n)} x the least)",
                   forced(case_args(n, h17), route, slots), route, n, h17)
    trace_pad_probe(torch, forced(case_args(dfc.ONE_CTA_LANES, h17),
                                  "block", block_slots(dfc.ONE_CTA_LANES)),
                    "dedup_", 1)
    # The parent's launch on the main path: the grid at the least table
    # over all B lanes, DRAIN_MAIN of them valid.
    args = case_args(DRAIN_MAIN, h17, batch)
    timed_call(f"the parent's launch: grid on all {batch} lanes, "
               f"{DRAIN_MAIN} valid, {dfc.table_slots(batch)} slots",
               forced(args, "grid", dfc.table_slots(batch)), "grid", batch,
               h17)
    ms, _, plain_ms, bound = times["main path, the staged lanes"]
    record("dedup_filter", err, ms, plain_ms, bound,
           "firedancer_tpu/ops/dedup_filter.py:84",
           "firedancer_tpu_torch/ops/csrc/dedup_filter.cu")


def traced_call_ms(torch, fn, prefix: str, kernels: int, want_ops: int,
                   reps: int = REPS, tries: int = 4, pad_s=TRACE_PAD_S):
    """(device ms a call, device operations a call, launches held by each
    trace taken, accepted) of reps warm calls of fn by the trace, each
    call launching `kernels` kernels whose names start with prefix and
    want_ops device operations in all. The trace records the second of
    two steps (the first, a warm-up, is discarded). Kineto keeps a device
    activity only when its timestamps, converted to the host's clock,
    fall inside the recorded step's window on that clock; a step of reps
    calls of a kernel of a few microseconds lasts well under a
    millisecond, so an error of that size in the conversion dropped whole
    traces late in a full run of this script (0, 0 and 15 of 20 launches
    of one shape). Each step therefore waits pad_s of host time after the
    device is idle before its first launch and after its last. A trace
    is accepted when it holds at least 90 % of the reps' launches and
    want_ops operations for each call it holds; its times are over the
    calls it holds. Otherwise it is taken again, up to tries times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    held = []
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(pad_s)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad_s)
                prof.step()
        busy, ops = trace_busy(prof)
        held.append(trace_kernels_ms(prof, prefix)[1])
        calls = held[-1] / kernels
        if held[-1] >= 0.9 * kernels * reps and ops == want_ops * calls:
            return busy * 1e3 / calls, ops / calls, held, True
    return 0.0, 0.0, held, False


def trace_pad_probe(torch, fn, prefix: str, kernels: int,
                    traces: int = 5) -> None:
    """The padding's A/B: launches of fn held by traces taken with no pad
    and with TRACE_PAD_S, in turns."""
    held = {0.0: [], TRACE_PAD_S: []}
    for _ in range(traces):
        for pad in held:
            held[pad].append(traced_call_ms(torch, fn, prefix, kernels, 0,
                                            tries=1, pad_s=pad)[2][0])
    say(f"  trace pad A/B, launches held of {kernels * REPS} a trace: "
        + "; ".join(f"pad {pad * 1e3:.0f} ms {held[pad]}" for pad in held))


def pipe_traffic(fixtures, fx_ok, corpus) -> dict:
    """A pipeline run's payloads (the fixtures, then the corpus) and what
    the sink must get: the digest multiset of the valid txns, the count
    of every other txn (each must land in a filter) and the fixtures the
    pack drops. The fixtures the oracle accepts reach the pack, which
    drops those with a malformed compute-budget instruction or an
    estimate over a bank's CU budget (the corpus has neither)."""
    import hashlib

    from firedancer_tpu_torch.ballet.pack import CuEstimator
    from firedancer_tpu_torch.disco import corpus as dcorpus
    from firedancer_tpu_torch.disco.tiles import pack_txn

    cls = collections.Counter(int(e) for e in corpus.expected)
    want = dcorpus.expected_sink_digests(corpus)
    est = CuEstimator()
    fx_bad_budget = fx_over_cap = 0
    for p, ok in zip(fixtures, fx_ok):
        t = pack_txn(p, 0, est) if ok else None
        if not ok:
            continue
        if t is None:
            fx_bad_budget += 1
        elif t.est_cus > PACK_CAP:
            fx_over_cap += 1
        else:
            want[hashlib.sha256(p).digest()] += 1
    return {"payloads": fixtures + corpus.payloads, "want": want,
            "not_ok": (cls[dcorpus.DUP] + cls[dcorpus.BAD_SIG]
                       + cls[dcorpus.BAD_PARSE] + fx_ok.count(False)
                       + fx_bad_budget + fx_over_cap),
            "fx_over_cap": fx_over_cap, "fx_bad_budget": fx_bad_budget}


def rotation_traffic(bench, tcache_depth: int = ROT_TCACHE,
                     n_unique: int = ROT_UNIQUE, every: int = ROT_EVERY,
                     seed: int = 9) -> dict:
    """Phase 9 (r)'s payloads: n_unique valid txns of the bench corpus in
    order, each followed by a copy with one byte of its first signature
    changed (verify drops it; it fills the verify tile's HA TCache, which
    takes every payload, while the dedup tile's takes valid txns only).
    After every every-th valid txn comes a repeat of an earlier one,
    alternately near (1 to tcache_depth / 4 valid txns back: the HA
    filter drops it) and far (0.52 to 0.85 tcache_depth back: more than
    tcache_depth payloads back, so the HA TCache has evicted it, yet
    fewer valid txns back than the dedup TCache holds, so the dedup
    tile drops it, and the window must not claim it novel). The expected
    filter counts go with it ("ha", "dedup") and min_rot 1."""
    import hashlib

    from firedancer_tpu_torch.disco import corpus as dcorpus

    rng = np.random.RandomState(seed)
    ok = [p for p, e in zip(bench.payloads, bench.expected)
          if e == dcorpus.OK][:n_unique]
    near_hi = tcache_depth // 4
    far_lo, far_hi = int(0.52 * tcache_depth), int(0.85 * tcache_depth)
    payloads, n_near, n_far, used = [], 0, 0, set()
    for i, p in enumerate(ok):
        bad = bytearray(p)
        bad[1 + i % 64] ^= 1 + i % 255
        payloads += [p, bytes(bad)]
        if not i or i % every:
            continue
        near = (i // every) % 2 == 1
        if not near and i < far_hi:
            continue
        # Each txn is repeated once at most: a second repeat would
        # measure its distance from the first.
        back = 0
        while not back or i - back in used:
            back = (rng.randint(1, min(near_hi, i) + 1) if near
                    else rng.randint(far_lo, far_hi + 1))
        used.add(i - back)
        n_near += near
        n_far += not near
        payloads.append(ok[i - back])
    return {"payloads": payloads,
            "want": collections.Counter(hashlib.sha256(p).digest()
                                        for p in ok),
            "not_ok": len(ok) + n_near + n_far, "fx_over_cap": 0,
            "fx_bad_budget": 0, "ha": n_near, "dedup": n_far, "min_rot": 1}


def drain_pack_capture(tiles):
    """Wrap the verify tile's drain_pack_step so that each call keeps the
    coloring's CUDA inputs and its colors (clones on the same stream) for
    a check against the plain version after the run. Returns (kept,
    restore)."""
    real = tiles.drain_pack_step
    kept = []

    def step(*args, **kw):
        out = real(*args, **kw)
        kept.append((tuple(a.clone() for a in args[5:9]), dict(kw),
                     out[3].clone()))
        return out

    tiles.drain_pack_step = step
    return kept, lambda: setattr(tiles, "drain_pack_step", real)


def drain_pack_parity(torch, kept) -> None:
    """The first and the last verify batch that drain_pack colored (N =
    B rows, a pad row for each lane past the batch's txns and for a txn
    the pack cannot take), lane for lane against pack_schedule_ref on
    the same CUDA tensors."""
    from firedancer_tpu_torch.ops import pack_gc

    if not kept:
        fail("drain_pack: no coloring was captured")
    notes = []
    for k in sorted({0, len(kept) - 1}):
        (w, r, scores, cus), kw, got = kept[k]
        want = pack_gc.pack_schedule_ref(w, r, scores, cus, **kw)
        if not torch.equal(got, want):
            fail(f"drain_pack batch {k}: {int((got != want).sum())} of "
                 f"{got.numel()} colors differ from the plain version")
        pads = int(((w < 0).all(dim=1) & (r < 0).all(dim=1)).sum())
        notes.append(f"batch {k}: N = {got.numel()}, {pads} lock-free rows, "
                     f"{int(got.max()) + 1} colors")
    say("drain_pack: pack_schedule equal to the plain version lane for lane "
        f"({'; '.join(notes)}; {len(kept)} batches colored)")


def flight_problems(res, tile=None, prom_path=None) -> list:
    """fd_flight's gates on a run (phases 8, 9 and 12): with spans on,
    each link's span counts every frag published on the link and the
    sink's every receipt; verify_stats equals the registry's verify row
    field for field and, given the feed's verify tile, the tile's own
    counters (its batch log, slot pool and breaker); with the sentinel
    on, it polled at least once a second of the run; the Prometheus
    text at prom_path parses and carries the verify row."""
    from firedancer_tpu_torch.disco import flight
    from firedancer_tpu_torch.disco.tiles import (
        FLUSH_DEADLINE,
        FLUSH_STARVED,
    )

    problems = []
    if any(h["n"] for h in res.stage_hist.values()):
        for link in ("replay_verify", "verify_dedup", "dedup_pack",
                     "pack_sink"):
            n, pub = res.stage_hist[link]["n"], \
                res.diag[f"link.{link}"]["tx_seq"]
            if n != pub:
                problems.append(f"span {link} n {n} != its publishes {pub}")
        if res.stage_hist["sink"]["n"] != res.recv_cnt:
            problems.append(f"span sink n {res.stage_hist['sink']['n']} != "
                            f"recv_cnt {res.recv_cnt}")
    vs, row = res.verify_stats[0], res.flight_tiles.get("verify", {})
    view = {k: vs[k] for k in row if k in vs}
    view["breaker_state"] = flight.BREAKER_STATE_CODE[vs["breaker_state"]]
    diff = {k: (v, row[k]) for k, v in view.items() if row[k] != v}
    if diff:
        problems.append(f"verify_stats against the registry row: {diff}")
    if tile is not None:
        log = tile.batch_log
        own = {"batches": len(log), "lanes": sum(n for n, _ in log),
               "flush_timeout": sum(v == FLUSH_DEADLINE for _, v in log),
               "flush_starved": sum(v == FLUSH_STARVED for _, v in log),
               "slot_stall": tile.feed_pool.slot_stall,
               "slots_leaked": tile.feed_pool.outstanding(),
               "breaker_state": (tile._breaker.state if tile._breaker
                                 else "disabled")}
        diff = {k: (vs[k], v) for k, v in own.items() if vs[k] != v}
        if diff:
            problems.append(f"verify_stats against the tile's own "
                            f"counters: {diff}")
    if res.slo is not None and res.slo["evals"] < int(res.elapsed_s):
        problems.append(f"the sentinel polled {res.slo['evals']} times in "
                        f"{res.elapsed_s:.1f} s")
    if prom_path is not None:
        try:
            with open(prom_path) as f:
                series = flight.parse_prom(f.read())
            got = series['fd_flight_batches{tile="verify"}']
            if got != vs["batches"]:
                problems.append(f"prom verify batches {got} != "
                                f"{vs['batches']}")
        except (OSError, ValueError, KeyError) as e:
            problems.append(f"prom text: {e!r}")
    return problems


def pipeline_run(torch, card, label, traffic, sched, batch, *,
                 depth=TILE_DEPTH, wksp_sz=TILE_WKSP, tcache_depth=PIPE_TCACHE,
                 verify_opts=None, feed=False, feed_proc=None, tile_hook=None,
                 mixed=False, flight=None, sentinel=None, xray=None,
                 live=None):
    """One run_pipeline on the card, replay -> verify -> dedup -> pack
    (sched) -> sink, with feed=False the in-process step loop (phase 8
    (b)), with feed=True the fd_feed runtime (phase 9; with tile_hook,
    run_feed_pipeline given the hook); exact accounting, launches and
    numbers. Launches are the batches' and those of the warm passes the
    run made (a rung warmed in the background: a direct batch each); the
    counts are read once the prewarm queue is idle. A feed run arms the
    fd_drain unless verify_opts say drain="off": every batch filtered
    once (one dedup_filter launch each), the novel and maybe publishes
    equal to verify's publishes and to the dedup tile's skipped and made
    probes, no false novel; with drain_pack, pack_schedule also launches
    once a verify batch and no block falls back to the greedy waves.
    Where the traffic gives "ha", "dedup" and "min_rot", the HA and
    dedup filters must drop exactly those counts and the window rotate
    at least min_rot times. mixed (a live reconfig's run: both verify
    modes, the drain switched off mid-run): every direct, fused RLC and
    dedup_filter kernel launched, some batches and not all filtered,
    the dedup tile's skipped probes equal to the novel claims and its
    probes to verify's publishes, no false novel. fd_flight's gates
    (flight_problems) hold on every run; a feed run goes through
    run_feed_pipeline (run_pipeline's route for it) with a hook that
    keeps the verify tile. flight, sentinel and xray are the run's
    options; live(topo), if given, is called once the topology exists and returns
    a function called after the run, before the workspace is removed.
    Returns (result, launches)."""
    from firedancer_tpu_torch.disco import pipeline
    from firedancer_tpu_torch.disco.engine import registry
    from firedancer_tpu_torch.disco.feed.runtime import run_feed_pipeline
    from firedancer_tpu_torch.ops import backend
    from torch.profiler import ProfilerActivity, profile

    vopts = dict(verify_opts or {"inflight": 2, "verify_mode": "direct"})
    mode = vopts["verify_mode"]
    payloads = traffic["payloads"]
    path = os.path.join(REPO, "build", "pipeline_smoke.wksp")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    topo = pipeline.build_topology(path, depth=depth, wksp_sz=wksp_sz)
    reg = registry()
    warms0 = {e: e.warms for e in reg.entries()}
    seen = {}

    def keep(v):
        seen["tile"] = v
        if tile_hook is not None:
            tile_hook(v)

    prom_path = (flight or {}).get("metrics_prom")
    try:
        finish = live(topo) if live is not None else None
        torch.cuda.synchronize()
        backend.reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kw = dict(verify_backend="gpu", verify_batch=batch,
                      tcache_depth=tcache_depth, record_digests=True,
                      pack_scheduler=sched, timeout_s=600.0,
                      verify_opts=vopts, feed_proc=feed_proc,
                      flight=flight, sentinel=sentinel, xray=xray)
            if not feed:
                res = pipeline.run_pipeline(topo, payloads, feed=feed, **kw)
            else:
                res = run_feed_pipeline(topo, payloads, tile_hook=keep, **kw)
            idle_by = time.perf_counter() + 120.0
            while not reg.prewarm_idle() and time.perf_counter() < idle_by:
                time.sleep(0.01)
            torch.cuda.synchronize()
        launches, plain = dict(backend.launches), dict(backend.plain_calls)
        if finish is not None:
            res.live = finish()
    finally:
        os.remove(path)
    warmed = {e.key: (e.spec.mode, e.warms - warms0.get(e, 0))
              for e in reg.entries() if e.warms > warms0.get(e, 0)}

    d = res.diag
    filt = (d["tile.verify"]["ha_filt_cnt"] + d["tile.verify"]["sv_filt_cnt"]
            + d["link.verify_dedup"]["filt_cnt"]
            + d["link.dedup_pack"]["filt_cnt"])
    vs, ps = res.verify_stats[0], res.pack_stats
    fx_over_cap = traffic["fx_over_cap"]
    problems = []
    got = collections.Counter(res.sink_digests)
    want = traffic["want"]
    if got != want:
        problems.append(f"sink multiset differs: {sum((want - got).values())}"
                        f" missing, {sum((got - want).values())} unexpected")
    if filt != traffic["not_ok"]:
        problems.append(f"filters {filt} != DUP + BAD_SIG + BAD_PARSE + "
                        "fixtures the oracle or the pack rejects "
                        f"{traffic['not_ok']}")
    if ps["cu_drop"] != fx_over_cap:
        problems.append(f"CU-cap drops {ps['cu_drop']} != the fixtures "
                        f"over the cap {fx_over_cap}")
    if len(res.bank_hist) < 2:
        problems.append(f"one bank only: {res.bank_hist}")
    want_l = tile_want_launches(mode, vs["batches"], vs["rlc_fallback"])
    for key, (wmode, n) in warmed.items():
        if wmode != "direct" and not mixed:
            problems.append(f"an {wmode} warm in the run ({key})")
        for k in DIRECT_KERNELS:
            want_l[k] = want_l.get(k, 0) + n
    drained = feed and vopts.get("drain", "auto") != "off"
    ds = res.dedup_stats
    claims = vs["drain_novel"] + vs["drain_maybe"]
    if mixed:
        pubs = d["link.verify_dedup"]["tx_seq"]
        if not 0 < vs["drain_batches"] < vs["batches"]:
            problems.append(f"drain batches {vs['drain_batches']} not in "
                            f"(0, {vs['batches']})")
        if (ds["probe_skip"] != vs["drain_novel"]
                or ds["probe_skip"] + ds["probed"] != pubs):
            problems.append(f"dedup probes {ds} against novel "
                            f"{vs['drain_novel']} and publishes {pubs}")
        if ds["false_novel"]:
            problems.append(f"false novel {ds['false_novel']}")
    elif drained:
        want_l["dedup_filter"] = vs["drain_batches"]
        if vs["drain_batches"] != vs["batches"]:
            problems.append(f"drain batches {vs['drain_batches']} != "
                            f"batches {vs['batches']}")
        if claims != d["link.verify_dedup"]["tx_seq"]:
            problems.append(f"drain novel + maybe {claims} != verify's "
                            f"publishes {d['link.verify_dedup']['tx_seq']}")
        if ds["probe_skip"] + ds["probed"] != claims:
            problems.append(f"dedup probes {ds} != drain novel + maybe "
                            f"{claims}")
        if ds["false_novel"]:
            problems.append(f"false novel {ds['false_novel']}")
        if "min_rot" in traffic:
            ha = d["tile.verify"]["ha_filt_cnt"]
            dd = d["link.verify_dedup"]["filt_cnt"]
            if (ha, dd) != (traffic["ha"], traffic["dedup"]):
                problems.append(f"HA and dedup drops {ha}, {dd} != the "
                                f"repeats planted for each {traffic['ha']}, "
                                f"{traffic['dedup']}")
            if vs["drain_rot"] < traffic["min_rot"]:
                problems.append(f"rotations {vs['drain_rot']} < "
                                f"{traffic['min_rot']}")
    elif vs["drain_batches"] or claims or ds["probe_skip"]:
        problems.append(f"drain off, yet {vs['drain_batches']} batches "
                        f"filtered, {claims} verdicts, dedup {ds}")
    if sched == "gc":
        if ps["block_device"] + ps["sched_fallback"] != ps["blocks"]:
            problems.append(f"gate accounting: {ps}")
        # The pack colors the blocks it gathers itself; with drain_pack
        # each verify batch is colored behind its filter.
        want_l["pack_schedule"] = ps["blocks"] - ps["dev_blocks"]
        if vopts.get("drain_pack"):
            want_l["pack_schedule"] += vs["drain_batches"]
            if not ps["dev_blocks"]:
                problems.append("drain_pack: no device block reached the "
                                "pack")
            if ps["sched_fallback"]:
                problems.append(f"drain_pack: {ps['sched_fallback']} blocks "
                                "fell back to the greedy waves")
    want_l = {k: v for k, v in want_l.items() if v}
    if mixed:
        want_l = {k: launches.get(k, 0) for k in (
            *DIRECT_KERNELS, *FRONT_LAUNCHES["fused"], *RLC_PASS,
            "dedup_filter")}
        if not all(want_l.values()):
            problems.append(f"a kernel of the run's paths was not "
                            f"launched: {want_l}")
    elif launches != want_l:
        problems.append(f"launches {launches} != {want_l}")
    if plain:
        problems.append(f"plain versions ran: {plain}")
    if res.feed != feed or res.feed_fallback_reason is not None:
        problems.append(f"feed {res.feed}, fallback reason "
                        f"{res.feed_fallback_reason!r}; want feed={feed}")
    problems += healing_problems(res.verify_stats)
    problems += flight_problems(res, seen.get("tile"), prom_path)
    if feed:
        in_proc = sched == "gc" or not feed_proc
        if ("workers" in res.proc_cpu_s) == in_proc:
            problems.append(f"process layout: {res.proc_cpu_s}")
        if vs["slots_leaked"]:
            problems.append(f"slots_leaked {vs['slots_leaked']}")

    busy, _ = trace_busy(prof)
    span = res.span_s
    share = (f"device busy {busy * 1e3:.1f} ms of {span * 1e3:.1f} = "
             f"{100 * busy / span:.2f}% (torch.profiler, the main process)"
             if busy > 0
             else "device busy share not measured (no device time traced)")
    say(f"{label}: {len(payloads)} txns in {span:.3f} s from the first "
        f"publish to the last sink frag = {len(payloads) / span:.0f} txn/s "
        f"(host clock; run {res.elapsed_s:.3f} s); latency p50 "
        f"{res.latency_p50_ns / 1e6:.3f} ms, p99 "
        f"{res.latency_p99_ns / 1e6:.3f} ms [{card}]")
    pubs = ", ".join(f"{k} {d['link.' + k]['tx_seq']}"
                     for k in ("replay_verify", "verify_dedup", "dedup_pack",
                               "pack_sink"))
    say(f"{label}: published by link {pubs}; sink {res.recv_cnt} to banks "
        f"{dict(sorted(res.bank_hist.items()))}; filters HA "
        f"{d['tile.verify']['ha_filt_cnt']}, SV "
        f"{d['tile.verify']['sv_filt_cnt']}, dedup "
        f"{d['link.verify_dedup']['filt_cnt']}, pack "
        f"{d['link.dedup_pack']['filt_cnt']} (CU-cap drops "
        f"{ps['cu_drop']}: {fx_over_cap} fixtures over the cap, 0 of the "
        f"corpus; {traffic['fx_bad_budget']} fixtures with a malformed "
        "compute-budget instruction)")
    cpu = ", ".join(f"{k} {v:.3f}" for k, v in res.tile_cpu_s.items())
    say(f"{label}: thread CPU s by tile: {cpu}; verify {vs['batches']} "
        f"batches, fill {vs['fill_ratio']}, RLC fallbacks "
        f"{vs['rlc_fallback']}; {share} [{card}]")
    if feed:
        dev_ms, dev_n = trace_kernels_ms(prof, "dedup_")
        say(f"{label}: drain {vopts.get('drain', 'auto')}: "
            f"{vs['drain_batches']} batches filtered, novel "
            f"{vs['drain_novel']}, maybe {vs['drain_maybe']}, rotations "
            f"{vs['drain_rot']}; dedup probes skipped {ds['probe_skip']}, "
            f"made {ds['probed']}, false novel {ds['false_novel']}; the "
            f"filter's kernels {dev_ms:.3f} ms of device time in {dev_n} "
            "launches (trace)")
        stages = "; ".join(
            f"{k} n {v['n']} p50 {v['p50_ns'] / 1e6:.3f} p99 "
            f"{v['p99_ns'] / 1e6:.3f}" for k, v in res.stage_latency.items())
        procs = ", ".join(f"{k} {v:.3f}" for k, v in res.proc_cpu_s.items())
        say(f"{label}: stage latency ms from the replay's publish: {stages}")
        say(f"{label}: CPU s by process: {procs} ({os.cpu_count()} cores); "
            f"slot stalls {vs['slot_stall']} ({vs['slot_stall_ms']} ms), "
            f"device idle estimate {vs['device_idle_est_ms']} ms, stager "
            f"restarts {vs['stager_restarts']}, cpu failover "
            f"{vs['cpu_failover']}, quarantined {vs['quarantined']}, "
            f"breaker {vs['breaker_state']} ({vs['breaker_trips']} trips), "
            f"slots leaked {vs['slots_leaked']} [{card}]")
    spans = "; ".join(f"{k} n {v['n']} p50<= {v['p50_ns_le'] / 1e6:.3f} "
                      f"p99<= {v['p99_ns_le'] / 1e6:.3f}"
                      for k, v in res.stage_hist.items() if v["n"])
    slo = res.slo
    # Each alert with the tiles it names (heartbeat) or its burn.
    alerts = [(a["slo"], a.get("tiles", a["burn_milli"]))
              for a in (slo or {}).get("alerts", ())]
    say(f"{label}: fd_flight spans ms (log2 buckets, every frag): "
        f"{spans or 'off'}; fd_sentinel "
        + (f"{slo['evals']} polls in {res.elapsed_s:.1f} s, alerts {alerts}"
           if slo else "off"))
    if sched == "gc":
        say(f"{label}: {ps['blocks']} blocks ({ps['dev_blocks']} colored "
            f"by the drain), {ps['block_device']} device "
            f"schedules accepted ({ps['wave_device']} waves), "
            f"{ps['sched_fallback']} fallbacks to the greedy waves; "
            f"schedule_block {ps['gc_s']:.3f} s, gate {ps['gate_s']:.3f} s "
            f"of the pack thread's wall")
    if problems:
        fail(f"{label}: " + "; ".join(problems))
    say(f"{label}: sink multiset and filter accounting exact, launches = "
        f"{launches if mixed else want_l}, no plain call; warm passes in "
        f"the run {warmed or 'none'}")
    return res, launches


def pack_phase(torch, card, record, fixtures, fx_ok, corpus,
               batch: int = B) -> None:
    """Phase 8: the pack kernel's parity and times, then the five-tile
    pipeline on the card with each scheduler, through the in-process
    step loop (feed=False)."""
    pack_kernel_phase(torch, record, pack_blocks(fixtures, corpus))
    traffic = pipe_traffic(fixtures, fx_ok, corpus)
    for sched in ("greedy", "gc"):
        pipeline_run(torch, card, f"pipeline {sched}", traffic, sched, batch)


def feed_phase(torch, card, rows, record, fixtures, fx_ok, corpus,
               batch: int = B):
    """Phase 9: run_pipeline through the fd_feed runtime on the card, the
    fd_drain armed (its default) unless a run says otherwise. First
    phase 3's dedup_filter parity on the meta sigs of (a)'s corpus
    (drain_kernel_phase). (a) the bench's replay shape (bench.py:287-315):
    FEED_N txns of mainnet_corpus(seed=1234) built and signed on the
    card, rings of FEED_DEPTH, inflight 4, a 200 ms deadline, greedy,
    worker processes, twice: drain on, then off (the A/B); (r) rotation_traffic at run_pipeline's default TCache, whose
    automatic quota the run passes; (b) phase 8's traffic in five runs: in
    process and in worker processes (greedy, direct), gc (in process,
    forced), rlc (worker processes), and gc with drain_pack (each verify
    batch colored; the first and the last coloring held to the plain
    version). Each kernel row's launches are those of the first run of
    this phase that runs it. Returns (a)'s corpus."""
    from firedancer_tpu_torch.disco import corpus as dcorpus
    from firedancer_tpu_torch.disco import tiles
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.disco.tiles import meta_sig
    from firedancer_tpu_torch.ops.dedup_filter import DEFAULT_FILTER_BITS

    t0 = time.perf_counter()
    bench = dcorpus.mainnet_corpus(n=FEED_N, seed=FEED_SEED)
    torch.cuda.synchronize()
    classes = collections.Counter(int(e) for e in bench.expected)
    say(f"feed corpus: mainnet_corpus(n={FEED_N}, seed={FEED_SEED}): "
        f"{len(bench.payloads)} payloads {dict(classes)}, built and signed "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    drain_kernel_phase(torch, record, np.array(
        [meta_sig(p) for p in bench.payloads], np.uint64), batch)
    # The filter warmed on both engines before the runs, so their counts
    # hold their own launches only.
    for mode in ("direct", "rlc"):
        registry().acquire(EngineSpec(mode, batch))[0].warm_drain(
            DEFAULT_FILTER_BITS)
    runs = {}
    for arm in ("auto", "off"):
        opts = dict(FEED_OPTS, drain=arm)
        prom = os.path.join(REPO, "build", f"feed_a_{arm}.prom")
        try:
            res, launches = pipeline_run(
                torch, card, f"feed (a) bench replay, worker processes, "
                f"drain {arm}", pipe_traffic([], [], bench), "greedy", batch,
                depth=FEED_DEPTH, wksp_sz=FEED_WKSP, verify_opts=opts,
                feed=True, feed_proc=True, flight={"metrics_prom": prom})
        finally:
            if os.path.exists(prom):
                os.remove(prom)
        runs.setdefault(arm, []).append((res, launches))
    for name in DIRECT_KERNELS + ("dedup_filter",):
        rows[name]["launches"] = runs["auto"][0][1][name]
    n_txn = len(bench.payloads)
    say("feed (a) drain A/B, on then off: " + "; ".join(
        f"{arm} " + ", ".join(
            f"{n_txn / r.span_s:.0f} txn/s p50 {r.latency_p50_ns / 1e6:.1f} "
            f"p99 {r.latency_p99_ns / 1e6:.1f} ms" for r, _ in rs)
        for arm, rs in runs.items()) + f" [{card}]")
    pipeline_run(torch, card, f"feed (r) window rotation, TCache "
                 f"{ROT_TCACHE}, worker processes", rotation_traffic(bench),
                 "greedy", batch, depth=FEED_DEPTH, wksp_sz=FEED_WKSP,
                 tcache_depth=ROT_TCACHE, verify_opts=dict(FEED_OPTS),
                 feed=True, feed_proc=True)
    traffic = pipe_traffic(fixtures, fx_ok, corpus)
    for label, sched, mode, proc, pack in (
            ("feed (b) in process", "greedy", "direct", False, False),
            ("feed (b) worker processes", "greedy", "direct", True, False),
            ("feed (b) gc, in process (forced)", "gc", "direct", True, False),
            ("feed (b) rlc, worker processes", "greedy", "rlc", True, False),
            ("feed (b) gc, drain_pack, in process (forced)", "gc", "direct",
             True, True)):
        kept, restore = drain_pack_capture(tiles) if pack else (None, None)
        try:
            _, launches = pipeline_run(
                torch, card, label, traffic, sched, batch,
                verify_opts={"inflight": 2, "verify_mode": mode,
                             "drain_pack": pack},
                feed=True, feed_proc=proc)
        finally:
            if pack:
                restore()
        if pack:
            drain_pack_parity(torch, kept)
        if sched == "gc" and not pack:
            rows["pack_schedule"]["launches"] = launches["pack_schedule"]
        if mode == "rlc":
            for name in ("frontend_rlc", *RLC_PASS):
                for row in TAILS_ROWS if name == "msm_tails" else (name,):
                    rows[row]["launches"] = launches[name]
    rung_kernel_parity(torch, bench)
    ladder_runs(torch, card, bench, [r for rs in runs.values()
                                     for r, _ in rs])
    reconfig_run(torch, card, bench)
    return bench


def rung_kernel_parity(torch, bench, device="cuda") -> None:
    """Rows 1-4 at the rungs above B (RUNG_B) against their plain
    versions on the same CUDA tensors, as phase 3 holds them at B: K1 on
    n rows of the bench's 256 bytes with lengths 0-256 (0, 111, 112, 239,
    240 planted), K2 on 2n encodings (the edge corpus first, then random
    bytes), K3 on n of K2's decoded points with random h and s, K4 on
    those points against (x Z : y Z : Z) at a random Z with X moved by
    one on about half the lanes. Then row 17 on the staged txns of a
    LADDER_B-lane batch of the bench corpus (its first txns that parse,
    up to LADDER_B signature lanes) at the tile's window: drain_cases'
    three inputs, the grid launch."""
    from firedancer_tpu_torch.ballet.ed25519 import corpus
    from firedancer_tpu_torch.ballet.txn import TxnParseError, parse_txn
    from firedancer_tpu_torch.disco.tiles import meta_sig
    from firedancer_tpu_torch.ops import curve_cuda, dsm_cuda
    from firedancer_tpu_torch.ops import dedup_filter as df
    from firedancer_tpu_torch.ops import dedup_filter_cuda as dfc
    from firedancer_tpu_torch.ops import fe25519 as fe
    from firedancer_tpu_torch.ops import frontend_cuda

    dev = torch.device(device)
    rng = np.random.RandomState(23)

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def parity(name, got, want):
        err = max_abs_err(torch, got, want)
        if err != 0:
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max_abs_err {err})")

    edge = np.frombuffer(b"".join(corpus.edge_encodings(rng)),
                         np.uint8).reshape(-1, 32)
    row = 64 + MSG_LEN
    for n in RUNG_B:
        lens = rng.randint(0, row + 1, n).astype(np.int32)
        lens[:5] = [0, 111, 112, 239, 240]
        msgs, lens = gpu(rng.randint(0, 256, (n, row), dtype=np.uint8)), \
            gpu(lens)
        parity(f"sha512_mod_l at {n}",
               frontend_cuda.sha512_mod_l_cuda(msgs, lens),
               frontend_cuda.sha512_mod_l_ref(msgs, lens))
        enc = rng.randint(0, 256, (2 * n, 32), dtype=np.uint8)
        enc[:len(edge)] = edge
        enc = gpu(enc)
        k2 = curve_cuda.decompress_so_cuda(enc)
        parity(f"decompress_so at {2 * n} lanes", k2,
               curve_cuda.decompress_so_ref(enc))
        ok_idx = torch.nonzero(k2[1]).flatten()
        a_pt = k2[0][ok_idx[torch.arange(n, device=dev)
                            % ok_idx.numel()]].contiguous()
        h, s = (gpu(rng.randint(0, 256, (n, 32), dtype=np.uint8))
                for _ in range(2))
        parity(f"double_scalarmult at {n}",
               dsm_cuda.double_scalarmult_cuda(h, a_pt, s),
               dsm_cuda.double_scalarmult_ref(h, a_pt, s))
        z = fe.fe_from_bytes(gpu(rng.randint(0, 256, (n, 32),
                                              dtype=np.uint8)))
        x, y = (fe.fe_from_limbs51(a_pt[:, c]) for c in (0, 1))
        one = fe.fe_from_limbs51(torch.tensor(
            [1, 0, 0, 0, 0], dtype=torch.int64, device=dev).expand(n, 5))
        X = fe.fe_mul(x, z)
        moved = gpu(rng.randint(0, 2, n).astype(np.bool_))
        X = torch.where(moved[:, None], fe.fe_add(X, one), X)
        proj = torch.stack([fe.fe_to_limbs51(c)
                            for c in (X, fe.fe_mul(y, z), z)], dim=1)
        proj = proj.contiguous()
        eq = curve_cuda.point_eq_affine_cuda(a_pt, proj)
        parity(f"point_eq at {n}", eq,
               curve_cuda.point_eq_affine_ref(a_pt, proj))
        if not bool((eq == ~moved).all()):
            fail(f"point_eq at {n}: a lane's verdict is not its own")
        say(f"rungs: sha512_mod_l, decompress_so ({2 * n} lanes), "
            f"double_scalarmult and point_eq equal to their plain versions "
            f"at n = {n} ({int(k2[1].sum())} encodings decode, "
            f"{int(eq.sum())} points equal)")
    tags, lanes = [], 0
    for p in bench.payloads:
        try:
            cnt = parse_txn(p).signature_cnt
        except TxnParseError:
            continue
        if lanes + cnt > LADDER_B:
            break
        lanes += cnt
        tags.append(meta_sig(p))
    tags = np.array(tags, np.uint64)
    n, h_bits = len(tags), df.DEFAULT_FILTER_BITS
    route = dfc.geometry(n, h_bits)[0]
    if route != "grid":
        fail(f"dedup_filter at {n} lanes: route {route}, want grid")
    for label, t, valid, bits_a, bits_b in drain_cases(
            tags, n, h_bits, rng, colliders(h_bits)):
        args = tuple(gpu(a) for a in (*df.split_tags(t), valid, bits_a,
                                      bits_b))
        for part, g, w in zip(("novel", "bank A", "count"),
                              dfc.dedup_filter_cuda(*args),
                              df.dedup_filter_ref(*args)):
            parity(f"dedup_filter {label} at {n} lanes ({part})", g, w)
    say(f"rungs: dedup_filter equal to its plain version on the {n} staged "
        f"txns ({lanes} lanes) of a {LADDER_B}-lane batch of the bench "
        f"corpus, window 2^{h_bits.bit_length() - 1}, route {route}, three "
        "inputs")


def ladder_runs(torch, card, bench, fixed) -> None:
    """Phase 9 (l), the engine ladder at full width: (a)'s corpus and
    options at B = LADDER_B on rings TILE_DEPTH deep, greedy, worker
    processes, the default ladder with the scheduler on (its primary
    engine and filter warmed before the run; the other rungs warm in the
    background during it), then off (the A/B): the sink exact, the
    ladder LADDER_RUNGS, every batch in rung_hist and at least two rungs
    used, every rung WARM, each rung used with a service EMA. fixed:
    (a)'s runs, printed beside."""
    from firedancer_tpu_torch.disco.engine import ENGINE_WARM, EngineSpec
    from firedancer_tpu_torch.disco.engine import registry
    from firedancer_tpu_torch.ops.dedup_filter import DEFAULT_FILTER_BITS

    reg = registry()
    traffic = pipe_traffic([], [], bench)
    n_txn = len(bench.payloads)
    t0 = time.perf_counter()
    prim, _ = reg.acquire(EngineSpec("direct", LADDER_B))
    prim.warm_drain(DEFAULT_FILTER_BITS)
    say(f"ladder: {prim.key} warmed in {time.perf_counter() - t0:.2f} s "
        f"(warm_s {prim.warm_s:.3f})")
    runs = {}
    for sched in (True, False):
        res, launches = pipeline_run(
            torch, card, f"feed (l) ladder B={LADDER_B}, sched {sched}, "
            "worker processes", traffic, "greedy", LADDER_B,
            verify_opts=dict(FEED_OPTS, sched=sched), feed=True,
            feed_proc=True)
        runs[sched] = res
        vs = res.verify_stats[0]
        say(f"feed (l) sched {sched}: rung_ladder {vs['rung_ladder']}, "
            f"rung_hist {vs['rung_hist']}, batches {vs['batches']}, fill "
            f"{vs['fill_ratio']}, switches {vs['rung_switches']}, rung_cur "
            f"{vs['rung_cur']}; launches {launches}")
    vs, problems = runs[True].verify_stats[0], []
    hist = vs["rung_hist"]
    if vs["rung_ladder"] != LADDER_RUNGS:
        problems.append(f"rung_ladder {vs['rung_ladder']}")
    if sum(hist.values()) != vs["batches"] or len(hist) < 2:
        problems.append(f"rung_hist {hist} against {vs['batches']} batches")
    off = runs[False].verify_stats[0]
    if off["rung_ladder"] or off["rung_hist"] or off["rung_switches"]:
        problems.append(f"sched=False run scheduled: {off['rung_ladder']}, "
                        f"{off['rung_hist']}")
    for r in LADDER_RUNGS:
        e = reg.entry(EngineSpec("direct", r))
        say(f"feed (l) rung {r}: {e.state}, warm_s {e.warm_s:.4f} "
            f"({e.warms} warm passes), service_ns {e.service_ns}, "
            f"dispatches {e.dispatches} [{card}]")
        if e.state != ENGINE_WARM or (str(r) in hist and not e.service_ns):
            problems.append(f"rung {r}: {e.state}, service_ns "
                            f"{e.service_ns}, err {e.err}")
    if problems:
        fail("feed (l): " + "; ".join(problems))
    say("feed (l) against (a)'s fixed B: " + "; ".join(
        f"{label} {n_txn / r.span_s:.0f} txn/s p50 "
        f"{r.latency_p50_ns / 1e6:.1f} p99 {r.latency_p99_ns / 1e6:.1f} ms"
        for label, r in ([("(a) B=8192 ring 4096", r) for r in fixed]
                         + [(f"(l) sched on B={LADDER_B}", runs[True]),
                            (f"(l) sched off B={LADDER_B}", runs[False])]))
        + f" [{card}]")


def reconfig_run(torch, card, bench) -> None:
    """Phase 9 (k), live reconfig on the card: (l)'s run on the first
    RECONFIG_N payloads of (a)'s corpus with a ReconfigController on a
    request file in a temporary directory. Once
    a batch has been dispatched RECONFIG_1 is written to it, once that
    applied RECONFIG_2, and the controller makes RECONFIG_3 as soon as
    RECONFIG_2 is accepted: two reconfigs and one refusal, the sink
    exact, the retired engines gone from the registry, the final mode
    and ladder RECONFIG_2's on RECONFIG_1's rungs, no leaked slot."""
    import tempfile
    import threading

    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.disco.soak import ReconfigController

    import hashlib

    from firedancer_tpu_torch.disco import corpus as dcorpus

    reg = registry()
    payloads = bench.payloads[:RECONFIG_N]
    # The corpus is shuffled, so a duplicate may come before its
    # original: in a prefix the first copy of each valid txn reaches
    # the sink, and every other payload lands in a filter.
    valid = {p for p, e in zip(payloads, bench.expected[:RECONFIG_N])
             if e in (dcorpus.OK, dcorpus.DUP)}
    traffic = {"payloads": payloads, "want": collections.Counter(
        hashlib.sha256(p).digest() for p in valid),
        "not_ok": len(payloads) - len(valid), "fx_over_cap": 0,
        "fx_bad_budget": 0}
    n_txn = len(payloads)
    dev = reg.acquire(EngineSpec("direct", LADDER_B))[0].device
    tmp = tempfile.mkdtemp(prefix="fd_reconfig_")
    path = os.path.join(tmp, "reconfig.json")

    def write(req):
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(req, f)
        os.replace(path + ".tmp", path)

    class Controller(ReconfigController):
        def apply(self, req):
            ent = super().apply(req)
            if req == RECONFIG_2 and ent["ok"]:
                super().apply(RECONFIG_3)
            return ent

    write({})   # there at start: does not fire
    ctl = Controller(path, poll_s=0.02)
    stop = threading.Event()
    seen, asked = {}, []

    def drive(v):
        for req, ready in ((RECONFIG_1, lambda: v.stat_batches >= 1),
                           (RECONFIG_2, lambda: v.stat_reconfigs >= 1)):
            while not ready():
                if stop.wait(0.002):
                    return
            asked.append((v.stat_batches, v.stat_reconfigs))
            write(req)

    def hook(v):
        seen["tile"] = v
        ctl.attach(v)
        ctl.start()
        threading.Thread(target=drive, args=(v,), daemon=True).start()

    # Retired: the direct rungs RECONFIG_1 left behind, then the rlc
    # rungs RECONFIG_2 left.
    final = sorted(set(RECONFIG_1["ladder"]) | {LADDER_B})
    old = ({EngineSpec("direct", r) for r in LADDER_RUNGS if r not in final}
           | {EngineSpec("rlc", r) for r in final})
    try:
        res, launches = pipeline_run(
            torch, card, f"feed (k) live reconfig B={LADDER_B}, worker "
            "processes", traffic, "greedy", LADDER_B,
            verify_opts=dict(FEED_OPTS), feed=True, feed_proc=True,
            tile_hook=hook, mixed=True)
    finally:
        stop.set()
        ctl.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    vs, v, problems = res.verify_stats[0], seen["tile"], []
    if (vs["reconfigs"], vs["reconfig_refused"]) != (2, 1):
        problems.append(f"reconfigs {vs['reconfigs']}, refused "
                        f"{vs['reconfig_refused']}")
    log = [(e["ok"], e["detail"]) for e in ctl.log]
    if [ok for ok, _ in log] != [True, True, False] \
            or "already pending" not in log[2][1]:
        problems.append(f"controller log {log}")
    keys = {s["key"] for s in reg.snapshot() if s["device"] == str(dev)}
    left = sorted(keys & {s.key for s in old})
    if left:
        problems.append(f"retired engines still registered: {left}")
    if (vs["mode"], vs["rung_ladder"]) != ("direct", final):
        problems.append(f"final mode {vs['mode']}, ladder "
                        f"{vs['rung_ladder']}")
    say(f"feed (k): requests written at (batches, reconfigs) {asked}; "
        f"controller log {log}; {vs['batches']} batches "
        f"(rung_hist {vs['rung_hist']}), {vs['drain_batches']} filtered, "
        f"RLC fallbacks {vs['rlc_fallback']}, mode now {v.verify_mode} on "
        f"{v._engine_entry.key}; registered {sorted(keys)}; launches "
        f"{launches}; {n_txn / res.span_s:.0f} txn/s p50 "
        f"{res.latency_p50_ns / 1e6:.1f} p99 {res.latency_p99_ns / 1e6:.1f}"
        f" ms [{card}]")
    if problems:
        fail("feed (k): " + "; ".join(problems))


def app_toml(path: str, scratch: str, lanes: int) -> str:
    """The app phase's operator TOML (app/config.py's keys)."""
    with open(path, "w") as f:
        f.write(f'name = "smoke"\nscratch_directory = "{scratch}"\n'
                f"[layout]\nverify_tile_count = {lanes}\n"
                f"depth = {APP_DEPTH}\nwksp_sz = {APP_WKSP}\n"
                f'[tiles.verify]\nbackend = "gpu"\nbatch = {B}\n'
                f"tcache_depth = {APP_TCACHE}\n"
                "[development]\ntimeout_s = 300.0\n"
                f"[development.synth]\ntxn_cnt = {APP_TXN}\n"
                f"dup_frac = {APP_FRAC}\nbad_frac = {APP_FRAC}\n")
    return path


def synth_want_launches(jobs: int) -> dict:
    """The synth's launches: one keygen_batch over its seeds, then
    sign_batch once a APP_SIGN_B jobs."""
    calls = -(-jobs // APP_SIGN_B)
    want = dict(KEYGEN_LAUNCHES)
    for k, v in SIGN_LAUNCHES.items():
        want[k] = want.get(k, 0) + v * calls
    return want


def app_run(torch, card, label, entry, argv, lanes, *, synth, feed):
    """One CLI call in process (entry is fdctl.main or fddev.main, on the
    card), its stdout echoed. run_pipeline is wrapped for the call: the
    counts are set to 0 just before the CLI (what comes before the
    pipeline is the synth's signing) and again as the pipeline starts,
    and read as it returns. Gates the run (the module docstring, phase
    10) and returns (result, payloads, launches)."""
    import contextlib
    import io

    from firedancer_tpu_torch.disco import pipeline
    from firedancer_tpu_torch.disco.engine import registry
    from firedancer_tpu_torch.disco.pipeline import lane_link
    from firedancer_tpu_torch.ops import backend

    reg = registry()
    rec = {}
    orig = pipeline.run_pipeline

    def recorded(topo, payloads, **kw):
        torch.cuda.synchronize()
        rec["sign"] = (dict(backend.launches), dict(backend.plain_calls))
        rec["payloads"] = payloads
        rec["warms"] = {e: e.warms for e in reg.entries()}
        backend.reset_counts()
        res = orig(topo, payloads, **kw)
        idle_by = time.perf_counter() + 60.0
        while not reg.prewarm_idle() and time.perf_counter() < idle_by:
            time.sleep(0.01)
        torch.cuda.synchronize()
        rec["run"] = (dict(backend.launches), dict(backend.plain_calls))
        rec["res"] = res
        return res

    out = io.StringIO()
    pipeline.run_pipeline = recorded
    try:
        torch.cuda.synchronize()
        backend.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = entry(argv)
        secs = time.perf_counter() - t0
    finally:
        pipeline.run_pipeline = orig
        for line in out.getvalue().splitlines():
            say(f"  {label}| {line}")
    if rc != 0 or "res" not in rec:
        fail(f"{label}: exit code {rc}, pipeline ran: {'res' in rec}")
    res, payloads = rec["res"], rec["payloads"]
    printed = json.loads([ln for ln in out.getvalue().splitlines()
                          if ln.startswith("{")][-1])
    launches, plain = rec["run"]
    sign_l, sign_plain = rec["sign"]
    d, vstats = res.diag, res.verify_stats
    problems = []
    want_ok = len(set(payloads[:APP_TXN])) if synth else len(set(payloads))
    if printed["recv_cnt"] != res.recv_cnt or res.recv_cnt != want_ok:
        problems.append(f"recv_cnt {res.recv_cnt} (printed "
                        f"{printed['recv_cnt']}) != the distinct valid txns "
                        f"{want_ok}")
    filt = sum(d["tile." + lane_link("verify", i)][k] for i in range(lanes)
               for k in ("ha_filt_cnt", "sv_filt_cnt"))
    filt += sum(d["link." + lane_link("verify_dedup", i)]["filt_cnt"]
                for i in range(lanes))
    filt += d["link.dedup_pack"]["filt_cnt"]
    if printed["sent"] != len(payloads) or len(payloads) - res.recv_cnt != filt:
        problems.append(f"sent {printed['sent']} - recv_cnt {res.recv_cnt} "
                        f"!= the filters {filt}")
    pubs = [d["link." + lane_link("replay_verify", i)]["tx_seq"]
            for i in range(lanes)]
    if len(vstats) != lanes or not all(pubs) or not all(
            v["batches"] for v in vstats):
        problems.append(f"lanes: replay_verify publishes {pubs}, batches "
                        f"{[v['batches'] for v in vstats]}")
    batches = sum(v["batches"] for v in vstats)
    want_l = {k: batches for k in DIRECT_KERNELS}
    if feed:
        want_l["dedup_filter"] = vstats[0]["drain_batches"]
        if vstats[0]["drain_batches"] != batches:
            problems.append(f"drain batches {vstats[0]['drain_batches']} "
                            f"!= batches {batches}")
        if res.dedup_stats["false_novel"]:
            problems.append(f"false novel {res.dedup_stats['false_novel']}")
    if launches != want_l or plain:
        problems.append(f"launches {launches} != {want_l}, plain {plain}")
    warmed = [e.key for e in reg.entries()
              if e.warms != rec["warms"].get(e, 0)]
    if warmed:
        problems.append(f"engines warmed in the run: {warmed}")
    if synth:
        want_s = synth_want_launches(APP_TXN)
        if sign_l != want_s or sign_plain:
            problems.append(f"synth launches {sign_l} != {want_s}, plain "
                            f"{sign_plain}")
    elif sign_l or sign_plain:
        problems.append(f"launches before the pipeline: {sign_l}")
    reason = (None if feed
              else f"verify_lane_cnt={lanes} (feed serves exactly 1 lane)")
    if res.feed != feed or res.feed_fallback_reason != reason:
        problems.append(f"feed {res.feed}, reason "
                        f"{res.feed_fallback_reason!r}; want {reason!r}")
    problems += healing_problems(vstats)
    span = res.span_s
    stages = "; ".join(
        f"{k} p50 {v['p50_ns'] / 1e6:.3f} p99 {v['p99_ns'] / 1e6:.3f} ms"
        for k, v in res.stage_latency.items() if v.get("n"))
    say(f"{label}: {len(payloads)} payloads, {res.recv_cnt} to the sink in "
        f"{span:.3f} s from the first publish to the last sink frag = "
        f"{len(payloads) / span:.0f} txn/s (host clock); run "
        f"{res.elapsed_s:.3f} s, the CLI call {secs:.2f} s; latency "
        f"{stages or 'not recorded (the CLI records no sink digests)'} "
        f"[{card}]")
    tiles = [d["tile." + lane_link("verify", i)] for i in range(lanes)]
    dedup = [d["link." + lane_link("verify_dedup", i)]["filt_cnt"]
             for i in range(lanes)]
    say(f"{label}: lanes {lanes}, replay_verify publishes {pubs}, batches "
        f"{[v['batches'] for v in vstats]}; filters HA "
        f"{[t['ha_filt_cnt'] for t in tiles]}, SV "
        f"{[t['sv_filt_cnt'] for t in tiles]}, dedup {dedup}, pack "
        f"{d['link.dedup_pack']['filt_cnt']}; feed {res.feed}, reason "
        f"{res.feed_fallback_reason!r}")
    say(f"{label}: launches in the run {launches}"
        + (f"; the synth's signing {sign_l}" if synth else ""))
    if problems:
        fail(f"{label}: " + "; ".join(problems))
    return res, payloads, launches


def chaos_run(torch, card, label, corpus, mode, batch: int = B):
    """One run_feed_pipeline of the chaos phase on the card, the injector
    armed with CHAOS_SEED and CHAOS_SCHEDULE, the verify tile kept
    through tile_hook (its CPU lane's lanes and wall time). Gates
    scripts/chaos_smoke.py's checks (the sink, each class's tri-counter,
    the pool, the breaker, the failover and the quarantine, the overrun
    and the CTL_ERR drops) and exact launches: the verify rows once a
    batch that reached the card (batches less those the CPU lane
    served), the direct rows once more a fallback of an rlc batch
    (rlc_fallback), dedup_filter once a batch (failover batches
    included), no warm pass and no plain call. Returns (result, lanes/s
    of the CPU lane)."""
    from firedancer_tpu_torch.disco import corpus as dcorpus
    from firedancer_tpu_torch.disco import pipeline
    from firedancer_tpu_torch.disco.engine import registry
    from firedancer_tpu_torch.disco.feed.runtime import run_feed_pipeline
    from firedancer_tpu_torch.ops import backend

    path = os.path.join(REPO, "build", "chaos_smoke.wksp")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    topo = pipeline.build_topology(path, depth=CHAOS_DEPTH,
                                   wksp_sz=FEED_WKSP)
    opts = dict(CHAOS_OPTS, verify_mode=mode)
    if mode == "rlc":
        opts["frontend"] = "fused"
    reg = registry()
    warms0 = {e: e.warms for e in reg.entries()}
    seen = {}
    try:
        torch.cuda.synchronize()
        backend.reset_counts()
        res = run_feed_pipeline(
            topo, corpus.payloads, verify_backend="gpu", verify_batch=batch,
            tcache_depth=CHAOS_TCACHE, record_digests=True, timeout_s=600.0,
            verify_opts=opts, feed_proc=False,
            tile_hook=lambda v: seen.setdefault("tile", v),
            chaos=(CHAOS_SEED, CHAOS_SCHEDULE))
        torch.cuda.synchronize()
        launches, plain = dict(backend.launches), dict(backend.plain_calls)
    finally:
        os.remove(path)
    warmed = [e.key for e in reg.entries() if e.warms != warms0.get(e, 0)]
    v, vs, d = seen["tile"], res.verify_stats[0], res.diag
    snap = vs.get("chaos") or {}
    counters = snap.get("counters") or {}
    problems = []
    corrupted = collections.Counter(
        bytes.fromhex(h) for h in snap.get("corrupted_sha256", ()))
    want = dcorpus.expected_sink_digests(corpus) - corrupted
    got = collections.Counter(res.sink_digests)
    if got != want or sum(corrupted.values()) != 1:
        problems.append(f"sink: {sum((want - got).values())} missing, "
                        f"{sum((got - want).values())} unexpected, "
                        f"{sum(corrupted.values())} corrupted (want 1)")
    if set(counters) != set(CHAOS_CLASSES):
        problems.append(f"classes audited {sorted(counters)}")
    for cls, c in counters.items():
        if not c["injected"] == c["detected"] == c["healed"] >= 1:
            problems.append(f"{cls}: {c}")
    for key, ok in (("slots_leaked", vs["slots_leaked"] == 0),
                    ("stager_restarts", vs["stager_restarts"] == 1),
                    ("breaker_trips", vs["breaker_trips"] >= 1),
                    ("breaker_reprobes", vs["breaker_reprobes"] >= 1),
                    ("breaker_state", vs["breaker_state"] == "closed"),
                    ("cpu_failover", vs["cpu_failover"] >= 1),
                    ("quarantined", vs["quarantined"] >= 1),
                    ("ctl_err_drop", vs["ctl_err_drop"] >= 2)):
        if not ok:
            problems.append(f"{key} {vs[key]}")
    ovr = d["link.replay_verify"]["ovrnr_cnt"]
    filt = d["link.verify_dedup"]["filt_cnt"]
    if ovr < 1:
        problems.append(f"replay_verify overruns {ovr}")
    if filt < vs["quarantine_err_txn"]:
        problems.append(f"verify_dedup filtered {filt} < the quarantine's "
                        f"CTL_ERR frags {vs['quarantine_err_txn']}")
    on_card = vs["batches"] - vs["cpu_failover"]
    want_l = tile_want_launches(mode, on_card, vs["rlc_fallback"])
    want_l["dedup_filter"] = vs["batches"]
    if mode == "rlc" and vs["rlc_fallback"] < 1:
        problems.append("no rlc batch fell back (the corrupted lane's "
                        "batch must)")
    if launches != want_l:
        problems.append(f"launches {launches} != {want_l}")
    if plain or warmed:
        problems.append(f"plain versions ran: {plain}; warmed: {warmed}")
    n = len(corpus.payloads)
    cpu_lps = v.stat_cpu_lanes / (v.stat_cpu_ns / 1e9) if v.stat_cpu_ns \
        else 0.0
    say(f"{label}: {n} txns in {res.span_s:.3f} s from the first publish "
        f"to the last sink frag = {n / res.span_s:.0f} txn/s (host clock; "
        f"run {res.elapsed_s:.3f} s); latency p50 "
        f"{res.latency_p50_ns / 1e6:.3f} ms, p99 "
        f"{res.latency_p99_ns / 1e6:.3f} ms [{card}]")
    say(f"{label}: CPU lane {v.stat_cpu_lanes} lanes in "
        f"{v.stat_cpu_ns / 1e6:.1f} ms = {cpu_lps:.0f} lanes/s (host clock, "
        f"the native verifier; {vs['cpu_failover']} failover batches, "
        f"{vs['quarantined']} quarantined) [{card}]")
    say(f"{label}: batches {vs['batches']} ({on_card} on the card), rlc "
        f"fallbacks {vs['rlc_fallback']}, breaker {vs['breaker_state']} "
        f"(trips {vs['breaker_trips']}, reprobes {vs['breaker_reprobes']}), "
        f"stager restarts {vs['stager_restarts']}, quarantine CTL_ERR "
        f"{vs['quarantine_err_txn']}, ctl_err drops {vs['ctl_err_drop']}, "
        f"replay_verify overruns {ovr}, verify_dedup filtered {filt}, "
        f"slots leaked {vs['slots_leaked']}; classes {counters}")
    if problems:
        fail(f"{label}: " + "; ".join(problems))
    say(f"{label}: the sink exact less the corrupted txn, every class "
        f"injected = detected = healed, launches = {want_l}, no plain call")
    return res, cpu_lps


def chaos_phase(torch, card, batch_b, direct_b, batch: int = B) -> None:
    """Phase 11: the healing lane on the card. The native verifier (the
    CPU lane) against K1-K4's statuses on phase 4's batch (b); then
    scripts/chaos_smoke.py's corpus, injector and breaker at the tile's
    size through the feed in verify mode direct, then rlc with the
    fused front half (chaos_run)."""
    from firedancer_tpu_torch.ballet.ed25519 import native
    from firedancer_tpu_torch.disco import corpus as dcorpus
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops.dedup_filter import DEFAULT_FILTER_BITS

    # Both engines and their filter warm before the runs (phase 9's live
    # reconfig retires engines), so the runs' counts hold their own.
    for mode in ("direct", "rlc"):
        registry().acquire(EngineSpec(mode, batch))[0].warm_drain(
            DEFAULT_FILTER_BITS)
    t0 = time.perf_counter()
    got = native.verify_arrays(*batch_b, len(direct_b))
    cpu_s = time.perf_counter() - t0
    bad = np.nonzero(got != direct_b)[0]
    if len(bad):
        fail(f"the CPU lane disagrees with K1-K4 on batch (b) at "
             f"{len(bad)} lanes, first {bad[:8].tolist()}: "
             f"{got[bad[:8]].tolist()} vs {direct_b[bad[:8]].tolist()}")
    say(f"CPU lane: native.verify_arrays equals K1-K4 on batch (b)'s "
        f"{len(direct_b)} lanes (status counts "
        f"{dict(zip(*np.unique(got, return_counts=True)))}), "
        f"{len(direct_b) / cpu_s:.0f} lanes/s (host clock) [{card}]")
    t0 = time.perf_counter()
    corpus = dcorpus.mainnet_corpus(n=CHAOS_N, seed=CHAOS_CORPUS_SEED,
                                    dup_rate=0.05, corrupt_rate=0.03,
                                    parse_err_rate=0.02, max_data_sz=140)
    torch.cuda.synchronize()
    say(f"chaos corpus: mainnet_corpus(n={CHAOS_N}, "
        f"seed={CHAOS_CORPUS_SEED}): {len(corpus.payloads)} payloads, "
        f"signed on the card in {time.perf_counter() - t0:.1f} s; injector "
        f"seed {CHAOS_SEED}, schedule {CHAOS_SCHEDULE}")
    for mode in ("direct", "rlc"):
        chaos_run(torch, card, f"chaos {mode}", corpus, mode, batch)


def late_trace_probe(torch) -> None:
    """The trace's padding A/B again at the end of the run: the filter's
    one block on 2,048 lanes, as the drain timing forces it."""
    from firedancer_tpu_torch.ops.dedup_filter import (
        DEFAULT_FILTER_BITS,
        dedup_filter,
        empty_banks,
    )

    dev = torch.device("cuda", 0)
    tags = torch.randint(-2**31, 2**31 - 1, (2, 2048), dtype=torch.int32,
                         device=dev)
    valid = torch.ones(2048, dtype=torch.bool, device=dev)
    banks = empty_banks(DEFAULT_FILTER_BITS, dev)
    trace_pad_probe(torch, lambda: dedup_filter(tags[0], tags[1], valid,
                                                *banks), "dedup_", 1)


def app_phase(torch, card) -> None:
    """Phase 10: the operator entry point on the card (the module
    docstring). Warms the direct engine at B and its drain filter first,
    so each run's launches are its batches' alone; callable alone after
    build.build_all() and rings.ensure_native_built()."""
    import contextlib
    import io
    import tempfile

    from firedancer_tpu_torch.app import fdctl, fddev
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops.dedup_filter import DEFAULT_FILTER_BITS
    from firedancer_tpu_torch.utils.pcap import PcapWriter

    t_phase = time.perf_counter()
    entry, _ = registry().acquire(EngineSpec("direct", B))
    entry.warm_drain(DEFAULT_FILTER_BITS)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="app_smoke_", dir=os.path.join(REPO, "build"))
    try:
        scratch = os.path.join(tmp, "scratch")
        one = app_toml(os.path.join(tmp, "one.toml"), scratch, 1)
        two = app_toml(os.path.join(tmp, "two.toml"), scratch, 2)
        _, payloads, _ = app_run(
            torch, card, "app (a) fddev dev, 1 lane",
            fddev.main, ["--config", one, "dev"], 1, synth=True, feed=True)
        cli = ["--config", two]
        if fdctl.main([*cli, "configure", "init", "all"]) != 0:
            fail("app (b): configure init all failed")
        try:
            app_run(torch, card, "app (b) fdctl run, 2 lanes", fdctl.main,
                    [*cli, "run"], 2, synth=True, feed=False)
            t0 = time.perf_counter()
            mon = io.StringIO()
            with contextlib.redirect_stdout(mon):
                rc = fdctl.main([*cli, "monitor", "--once", "--no-ansi"])
            for line in mon.getvalue().splitlines():
                say(f"  app (b) monitor| {line}")
            names = [ln.split()[0] for ln in mon.getvalue().splitlines()
                     if ln.strip()]
            if rc != 0 or not {"verify", "verify.v1", "replay_verify",
                               "replay_verify.v1", "verify_dedup.v1"
                               } <= set(names):
                fail(f"app (b): monitor --once exit {rc}, rows {names}")
            say(f"app (b) monitor --once: {time.perf_counter() - t0:.2f} s")
        finally:
            fdctl.main([*cli, "configure", "fini", "all"])
        pcap = os.path.join(tmp, "synth.pcap")
        with PcapWriter(pcap) as w:
            for p in payloads[:APP_PCAP_N]:
                w.write(p)
        cli = ["--config", one]
        if fdctl.main([*cli, "configure", "init", "all"]) != 0:
            fail("app (c): configure init all failed")
        try:
            app_run(torch, card, f"app (c) fdctl run --source pcap, "
                    f"{APP_PCAP_N} payloads, 1 lane", fdctl.main,
                    [*cli, "run", "--source", "pcap", "--pcap", pcap], 1,
                    synth=False, feed=True)
        finally:
            fdctl.main([*cli, "configure", "fini", "all"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"app phase: {time.perf_counter() - t_phase:.1f} s [{card}]")


def prefix_corpus(corpus, n: int):
    """The first n payloads of a corpus, relabelled: a txn's first copy
    in the prefix is valid and later copies are repeats (a repeat whose
    first copy lies past the cut becomes the valid one)."""
    from firedancer_tpu_torch.disco import corpus as dcorpus

    seen, exp = set(), []
    for p, e in zip(corpus.payloads[:n], corpus.expected[:n]):
        if e in (dcorpus.OK, dcorpus.DUP):
            e = dcorpus.DUP if p in seen else dcorpus.OK
            seen.add(p)
        exp.append(e)
    exp = np.asarray(exp, np.int8)
    return dcorpus.Corpus(list(corpus.payloads[:n]), exp,
                          n_unique_ok=int((exp == dcorpus.OK).sum()))


def live_probe(topo):
    """Read a run's registry while it runs: fd_top (a process of its own,
    a frame every PROBE_S) and monitor.snapshot (a thread here, every
    PROBE_S). Returns finish(), to call after the run and before the
    workspace goes: it stops both, runs fd_top's main with --prom on the
    final rows (here: the tool imports torch, seconds a process) and
    returns {"frames", "frames_err", "snaps", "prom"}."""
    import contextlib
    import importlib.util
    import io
    import threading

    from firedancer_tpu_torch.disco import monitor
    from firedancer_tpu_torch.tango.rings import Workspace

    pod_path = topo.wksp_path + ".pod"
    with open(pod_path, "wb") as f:
        f.write(topo.pod.serialize())
    tool = os.path.join(REPO, "firedancer_tpu_torch", "tools", "fd_top.py")
    args = ["--wksp", topo.wksp_path, "--pod", pod_path]
    proc = subprocess.Popen(
        [sys.executable, tool, *args, "--interval", str(PROBE_S),
         "--iterations", "600", "--no-ansi"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    snaps, stop = [], threading.Event()

    def loop():
        w = Workspace.join(topo.wksp_path)
        try:
            while not stop.wait(PROBE_S):
                snaps.append(monitor.snapshot(w, topo.pod))
        finally:
            w.leave()

    th = threading.Thread(target=loop, daemon=True)
    th.start()

    def finish():
        stop.set()
        th.join(timeout=10.0)
        proc.terminate()
        try:
            frames, err = proc.communicate(timeout=30.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            frames, err = proc.communicate()
        spec = importlib.util.spec_from_file_location("fd_top", tool)
        top = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(top)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = top.main([*args, "--prom"])
        os.remove(pod_path)
        if rc != 0:
            fail(f"fd_top --prom: rc {rc}")
        return {"frames": frames, "frames_err": err, "snaps": snaps,
                "prom": out.getvalue()}

    return finish


def _sink_counts(frames: str) -> list:
    """The sink span's n in each fd_top frame (its SPAN panel's rows)."""
    out, in_span = [], False
    for line in frames.splitlines():
        if line.startswith("SPAN"):
            in_span = True
        elif not line.strip():
            in_span = False
        elif in_span and line.split()[0] == "sink":
            out.append(int(line.split()[1]))
    return out


def live_problems(res, live: dict) -> list:
    """What an "on" run's live reads must show: the sink's span mid-run
    (0 < n < recv_cnt) in a snapshot and in an fd_top frame, the SLO
    rows polled, fd_top's SPAN and SLO panels, and its Prometheus text
    of the final rows equal to this process's but for the compile
    records."""
    from firedancer_tpu_torch.disco import flight

    problems = []
    total = res.recv_cnt
    mid = [s["span.sink"]["n"] for s in live["snaps"]
           if 0 < s["span.sink"]["n"] < total]
    if not mid:
        problems.append(f"no snapshot caught the sink's span mid-run "
                        f"({len(live['snaps'])} snapshots)")
    if not any(s["slo.pipeline_progress"]["evals"] for s in live["snaps"]):
        problems.append("no snapshot shows a polled SLO row")
    frames = live["frames"]
    tops = [n for n in _sink_counts(frames) if 0 < n < total]
    if not tops or "SLO" not in frames or "e2e_p99" not in frames:
        problems.append(f"fd_top showed no live SPAN and SLO panels "
                        f"({len(_sink_counts(frames))} frames with a sink "
                        f"row; stderr {live['frames_err'][-500:]!r})")

    def rows(text):
        return {k: v for k, v in flight.parse_prom(text).items()
                if not k.startswith("fd_flight_compile")}

    try:
        if rows(live["prom"]) != res.live_prom:
            problems.append("fd_top --prom differs from the run's text")
    except ValueError as e:
        problems.append(f"fd_top --prom does not parse: {e}")
    say(f"  live: {len(live['snaps'])} snapshots, sink span n mid-run "
        f"{mid[:3]}...; fd_top {len(_sink_counts(frames))} frames, sink "
        f"n {tops[:3]}...")
    return problems


def dump_problems(res, dump_dir: str) -> list:
    """The HALT dump of an "on" run (and the workers' dumps) in
    dump_dir: they parse, and the main one holds the verify row, the
    sink's span, the SLO rows and the verify recorder's dispatch and
    halt events."""
    names = sorted(os.listdir(dump_dir)) if os.path.isdir(dump_dir) else []
    halt = [n for n in names if n.endswith("_halt.json")]
    workers = [n for n in names if "halt_worker_" in n]
    if len(halt) != 1 or len(workers) != 2:
        return [f"dumps in {dump_dir}: {names}"]
    with open(os.path.join(dump_dir, halt[0])) as f:
        d = json.load(f)
    for n in workers:
        with open(os.path.join(dump_dir, n)) as f:
            json.load(f)
    problems = []
    kinds = {e["kind"] for e in d["recorders"]["verify"]["events"]}
    if (d["kind"], d["reason"]) != ("fd_flight_dump", "halt"):
        problems.append(f"dump kind {d['kind']}, reason {d['reason']}")
    if d["metrics"]["verify"]["batches"] != res.verify_stats[0]["batches"]:
        problems.append("dump's verify row differs from verify_stats")
    if d["edges"]["sink"]["n"] != res.recv_cnt:
        problems.append(f"dump's sink span {d['edges']['sink']}")
    if not d["slos"]["e2e_p99"]["evals"]:
        problems.append("dump's SLO rows were never polled")
    if not {"dispatch", "halt"} <= kinds:
        problems.append(f"verify recorder kinds {sorted(kinds)}")
    size = os.path.getsize(os.path.join(dump_dir, halt[0]))
    say(f"  dump: {halt[0]} ({size} bytes; recorders "
        f"{sorted(d['recorders'])}), workers' {workers}")
    return problems


def flight_host_costs(tmp: str) -> str:
    """The registry's host cost a call on this host, timed here: a span
    observe, a 1,200-frag bulk observe (a feed batch's publishes), a lane
    increment, a lane publish and a sentinel poll over a topology's
    registry."""
    from firedancer_tpu_torch.disco import flight, pipeline, sentinel
    from firedancer_tpu_torch.tango.rings import Workspace

    topo = pipeline.build_topology(os.path.join(tmp, "cost.wksp"), depth=64)
    w = Workspace.join(topo.wksp_path)
    try:
        h = flight.edge_hist(w, "sink")
        lane = flight.tile_lane(w, "verify")
        lats = np.random.RandomState(1).randint(0, 1 << 31, 1200)
        snt = sentinel.Sentinel(w, topo.pod)

        def per_call(fn, n):
            t = time.perf_counter_ns()
            for i in range(n):
                fn(i)
            return (time.perf_counter_ns() - t) / n

        obs = per_call(lambda i: h.observe(1000 + i), 100_000)
        many = per_call(lambda i: h.observe_many(lats), 1_000)
        inc = per_call(lambda i: lane.inc("lanes", 3), 100_000)
        pub = per_call(lambda i: (lane.inc("batches"), lane.publish()),
                       10_000)
        poll = per_call(lambda i: snt.poll(now=i * 0.25), 200)
        snt.stop()
    finally:
        w.leave()
    return (f"observe {obs:.0f} ns, observe_many of 1,200 {many / 1e3:.1f} "
            f"us, lane inc {inc:.0f} ns, lane publish {pub / 1e3:.1f} us, "
            f"sentinel poll {poll / 1e3:.1f} us")


def flight_phase(torch, card, bench, batch: int = B) -> None:
    """Phase 12: fd_flight and fd_sentinel on the card. (f) cut to the
    first FLIGHT_N payloads of phase 9's corpus (rings 4,096 deep, B =
    8192, inflight 4, worker processes, the drain on), four runs in
    turns, flight and sentinel off, on, on, off (pipeline_run's checks
    and flight gates on each). Every run is read live by fd_top in a
    process of its own and by monitor.snapshot on a thread (an "on" run
    must pass live_problems); an "on" run writes its Prometheus text and
    its HALT dump, and the workers theirs, into a temporary directory
    (dump_problems). Prints first the registry's host cost a call
    (flight_host_costs), then each run's txn/s and p50/p99 and the
    means on and off."""
    import tempfile

    from firedancer_tpu_torch.disco import flight

    t0 = time.perf_counter()
    corpus = prefix_corpus(bench, FLIGHT_N)
    traffic = pipe_traffic([], [], corpus)
    tmp = tempfile.mkdtemp(prefix="flight_", dir=os.path.join(REPO, "build"))
    runs = []
    try:
        say(f"flight (12) host cost a call: {flight_host_costs(tmp)} "
            f"[{card}]")
        for i, on in enumerate(FLIGHT_ARMS):
            dump_dir = os.path.join(tmp, f"dumps{i}")
            prom = os.path.join(tmp, f"run{i}.prom")
            fopts = ({"dump_dir": dump_dir, "metrics_prom": prom} if on
                     else {"enabled": False})
            res, _ = pipeline_run(
                torch, card, f"flight (f) first {FLIGHT_N} payloads, "
                f"flight and sentinel {'on' if on else 'off'}", traffic,
                "greedy", batch, depth=FEED_DEPTH, wksp_sz=FEED_WKSP,
                verify_opts=dict(FEED_OPTS), feed=True, feed_proc=True,
                flight=fopts, sentinel=on, live=live_probe)
            problems = []
            if on:
                with open(prom) as f:
                    res.live_prom = {
                        k: v for k, v in flight.parse_prom(f.read()).items()
                        if not k.startswith("fd_flight_compile")}
                problems += live_problems(res, res.live)
                problems += dump_problems(res, dump_dir)
                if res.slo is None or res.stage_hist["sink"]["n"] == 0:
                    problems.append("flight on, yet no spans or no sentinel")
            elif res.slo is not None or any(
                    h["n"] for h in res.stage_hist.values()):
                problems.append("flight off, yet spans or a sentinel")
            if problems:
                fail(f"flight run {i} ({'on' if on else 'off'}): "
                     + "; ".join(problems))
            runs.append((on, res))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = len(traffic["payloads"])

    def line(r):
        return (f"{n / r.span_s:.0f} txn/s p50 {r.latency_p50_ns / 1e6:.1f} "
                f"p99 {r.latency_p99_ns / 1e6:.1f} ms")

    say("flight (12) off/on in turns: " + "; ".join(
        f"{'on' if on else 'off'} {line(r)}" for on, r in runs)
        + f" [{card}]")
    mean = {a: np.mean([n / r.span_s for on, r in runs if on == a])
            for a in (False, True)}
    say(f"flight (12): mean txn/s off {mean[False]:.0f}, on {mean[True]:.0f}"
        f" (on/off {mean[True] / mean[False]:.3f}); the phase "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


def xray_live(topo):
    """live_probe, and at the run's end (the workspace still there) each
    link's trace ids read back from its mcache (None where the ring
    wrapped) and the xray queue rows."""
    probe = live_probe(topo)

    def finish():
        from firedancer_tpu_torch.disco import xray
        from firedancer_tpu_torch.tango.rings import (
            POLL_FRAG,
            MCache,
            Workspace,
        )

        out = probe()
        w = Workspace.join(topo.wksp_path)
        try:
            out["ids"] = {}
            for link in XRAY_LINKS:
                mc = MCache(w, f"{link}.mcache")
                n = mc.seq_next()
                ids = None
                if n <= mc.depth:
                    ids = np.zeros(n, np.uint64)
                    for seq in range(n):
                        r, frag = mc.poll(seq)
                        if r != POLL_FRAG:
                            fail(f"{link} seq {seq}: poll {r}")
                        ids[seq] = frag.tsorig
                out["ids"][link] = ids
            out["queue"] = xray.read_queue(w)
        finally:
            w.leave()
        return out

    return finish


def _frames(text: str) -> list:
    """fd_top's frames (each starts at its TILE header)."""
    out = []
    for line in text.splitlines():
        if line.startswith("TILE"):
            out.append([])
        if out:
            out[-1].append(line)
    return out


def xray_top_mid_run(frames: str, total: int) -> int:
    """fd_top frames that show the XRAY panel with a sampled dwell on a
    link while the sink's span is mid-run (0 < n < total)."""
    hits = 0
    for fr in _frames(frames):
        sink = [int(ln.split()[1]) for ln in fr
                if ln.split()[:1] == ["sink"] and len(ln.split()) == 4]
        if "XRAY" not in " ".join(fr) or not sink or \
                not 0 < sink[0] < total:
            continue
        i = next(k for k, ln in enumerate(fr) if ln.startswith("XRAY edge"))
        rows = []
        for ln in fr[i + 1:]:
            if not ln.strip():
                break
            rows.append(ln.split())
        if any(len(r) == 8 and r[0] in XRAY_LINKS and int(r[3]) > 0
               for r in rows):
            hits += 1
    return hits


def _autopsies(xdir: str) -> tuple:
    """(the HALT autopsy, [alert autopsies]) parsed from xdir; raises on
    a file that does not parse or is not an autopsy."""
    halt, alerts = [], []
    for name in sorted(os.listdir(xdir)) if os.path.isdir(xdir) else []:
        with open(os.path.join(xdir, name)) as f:
            a = json.load(f)
        if a.get("kind") != "xray_autopsy":
            fail(f"{name}: kind {a.get('kind')!r}")
        a["_file"] = os.path.join(xdir, name)
        (halt if a["reason"] == "halt" else alerts).append(a)
    return halt, alerts


def xray_on_problems(res, live: dict, xdir: str, total: int) -> list:
    """What an "on" run of (x) must show: each link's head count equal to
    sampled_mask over the ids it carried and the sink's over what the
    pack published; each sink head span's chain (where every ring still
    holds it) non-decreasing in latency; a dwell on every link; the
    waterfall reconciled with stage_hist; a HALT autopsy and at least
    one alert autopsy; tools/fd_xray.py --chrome-trace over the HALT
    autopsy parsing into an event a span; fd_top's XRAY panel mid-run;
    PipelineResult.xray's keys the JAX ones."""
    from firedancer_tpu_torch.disco import xray

    problems = []
    halt, alerts = _autopsies(xdir)
    if len(halt) != 1 or not alerts:
        return [f"autopsies in {xdir}: {len(halt)} HALT, {len(alerts)} "
                "alert"]
    spans = halt[0]["exemplars"]["spans"]
    thr = xray.sample_threshold()
    ids = dict(live["ids"], sink=live["ids"]["pack_sink"])
    heads = {}
    for edge, got_ids in ids.items():
        if got_ids is None:
            problems.append(f"{edge}'s ring wrapped")
            continue
        want = int(xray.sampled_mask(got_ids, thr).sum())
        got = spans.get(f"edge:{edge}", {}).get("counts", {}).get("head", 0)
        heads[edge] = (got, want, len(got_ids))
        if got != want or not want:
            problems.append(f"{edge}: {got} head spans, sampled_mask over "
                            f"its {len(got_ids)} ids {want}")
    # The chains the rings still hold (a ring keeps its last 512 spans,
    # and the 1 ms budget makes most spans tails): each trace at the sink
    # with spans on at least two more edges, its latency non-decreasing
    # along the chain, where no span's latency is past the 4 s wrap guard.
    chain = ("replay_verify", "verify_dedup", "dedup_pack", "pack_sink",
             "sink")
    by = {e: {s["trace"]: s["lat_ns"] for s in
              spans.get(f"edge:{e}", {}).get("spans", [])} for e in chain}
    chains = full = bad = 0
    for trace in by["sink"]:
        lats = [by[e][trace] for e in chain if trace in by[e]]
        if len(lats) < 3 or max(lats) >= 4_000_000_000:
            continue
        chains += 1
        full += len(lats) == len(chain)
        if lats != sorted(lats):
            bad += 1
    if bad or not chains:
        problems.append(f"{bad} of {chains} span chains not monotone")
    q = live["queue"]
    dry = [e for e in XRAY_LINKS if not q[e]["dwell"]["n"]]
    if dry:
        problems.append(f"no dwell on {dry}")
    wf = res.xray["waterfall"] if res.xray else []
    if not xray.waterfall_reconciles(res.stage_hist, wf):
        problems.append("the waterfall does not reconcile with stage_hist")
    if sorted(res.xray or {}) != XRAY_KEYS:
        problems.append(f"PipelineResult.xray keys {sorted(res.xray or {})}")
    out = os.path.join(xdir, "..", "chrome.json")
    tool = os.path.join(REPO, "firedancer_tpu_torch", "tools", "fd_xray.py")
    r = subprocess.run([sys.executable, tool, "--chrome-trace",
                        halt[0]["_file"], "-o", out],
                       capture_output=True, text=True, timeout=120)
    n_spans = sum(len(v["spans"]) for v in spans.values())
    try:
        with open(out) as f:
            xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
        if r.returncode or len(xs) != n_spans:
            problems.append(f"fd_xray --chrome-trace rc {r.returncode}, "
                            f"{len(xs)} events for {n_spans} spans")
    except (OSError, ValueError, KeyError) as e:
        problems.append(f"fd_xray --chrome-trace: {e!r} {r.stderr[-300:]}")
    top = xray_top_mid_run(live["frames"], total)
    if not top:
        problems.append(f"fd_top showed no XRAY panel mid-run (stderr "
                        f"{live['frames_err'][-300:]!r})")
    sus = alerts[0]["suspects"][0] if alerts[0]["suspects"] else {}
    say(f"  xray: head spans by edge (got, sampled_mask, ids) {heads}; "
        f"{chains} chains of 3-5 edges checked, {full} of all 5; exemplars {res.xray['exemplars']}, traces "
        f"{res.xray['traces']}; autopsies 1 HALT + {len(alerts)} alert "
        f"({sorted({a['reason'] for a in alerts})}), the first's suspect "
        f"{sus.get('stage')} ({sus.get('slo')}); chrome trace {n_spans} "
        f"events; fd_top XRAY frames mid-run {top}")
    return problems


def xray_waterfall_line(res) -> str:
    return "; ".join(
        f"{st['stage']} queue {st['queue_mean_ns'] / 1e6:.2f} ms "
        f"(n {st['queue_n']}) service "
        + ("-" if st["service_mean_ns"] is None
           else f"{st['service_mean_ns'] / 1e6:.2f} ms")
        + f" stall {st['stall_ns'] / 1e6:.1f} ms"
        for st in res.xray["waterfall"])


def xray_host_costs(tmp: str) -> str:
    """fd_xray's host cost a call on this host, timed here: a per-frag
    observe that captures nothing and one that captures a tail, a
    1,200-frag bulk observe that tails every frag (a feed batch past its
    budget), a drained round's dwell sample and an autopsy written with
    six full rings."""
    from firedancer_tpu_torch.disco import pipeline, xray
    from firedancer_tpu_torch.tango.rings import Workspace

    topo = pipeline.build_topology(os.path.join(tmp, "xcost.wksp"), depth=64)
    w = Workspace.join(topo.wksp_path)
    try:
        with xray.configured({"dir": os.path.join(tmp, "xcost")},
                             {"budgets": {"FD_SLO_E2E_BUDGET_MS": 1}}):
            ctx = xray.span_ctx("sink")
            cold = next(t for t in range(1, 1 << 20) if not xray.sampled(t))
            tail = ctx.tail_ns + 1
            ts = np.arange(1, 1201, dtype=np.uint64) * 977
            lats = np.full(1200, tail, np.int64)
            il = pipeline.in_link(w, "dedup_pack")
            tsp = np.ones(64, np.uint32)
            for e in ("replay_verify", "verify_dedup", "dedup_pack",
                      "pack_sink"):
                xray.span_ctx(e).observe_many(ts, lats)

            def per_call(fn, n):
                t = time.perf_counter_ns()
                for i in range(n):
                    fn(i)
                return (time.perf_counter_ns() - t) / n

            none = per_call(lambda i: ctx.observe(cold, cold + 5, 5), 100_000)
            tails = per_call(lambda i: ctx.observe(cold, cold + tail, tail),
                             100_000)
            many = per_call(lambda i: ctx.observe_many(ts, lats), 1_000)
            dwell = per_call(lambda i: il.dwell_round(tsp, 64), 10_000)
            autopsy = per_call(lambda i: xray.maybe_autopsy("cost", wksp=w),
                               10)
    finally:
        w.leave()
    return (f"observe (no capture) {none:.0f} ns, observe (a tail) "
            f"{tails:.0f} ns, observe_many of 1,200 tails "
            f"{many / 1e3:.1f} us, a 64-frag round's dwell sample "
            f"{dwell / 1e3:.1f} us, an autopsy of six full rings "
            f"{autopsy / 1e6:.1f} ms")


def xray_phase(torch, card, bench, batch: int = B) -> None:
    """Phase 13: fd_xray on the card. (x): (f) cut to the first XRAY_N
    payloads of phase 9's corpus on rings XRAY_DEPTH deep (B = 8192,
    inflight 4, the drain on, worker processes, flight and sentinel on
    with XRAY_SENTINEL), four runs in turns with xray off, on, on, off
    (pipeline_run's checks on each; an "on" run writes its autopsies
    into a temporary directory and must pass xray_on_problems, an "off"
    run must record no span, no queue row and no autopsy). Then one (l)
    run (B = 32,768, rings 32,768 deep, the ladder's scheduler on, xray
    on, the sentinel's defaults): the verify -> dedup edge's credit
    stall, the verify tile's tile_heartbeat alerts and the autopsies'
    first suspects, PERF.md's heartbeat question. Prints each run's
    txn/s and p50/p99, the means on and off, the launches and the
    phase's seconds."""
    import tempfile

    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops.dedup_filter import DEFAULT_FILTER_BITS

    t0 = time.perf_counter()
    # Both runs' primary engines and filters warm before the runs (phase
    # 9's live reconfig may have left a fresh entry at LADDER_B): a warm
    # inside a run would count its launches there.
    for b in (batch, LADDER_B):
        registry().acquire(EngineSpec("direct", b))[0].warm_drain(
            DEFAULT_FILTER_BITS)
    corpus = prefix_corpus(bench, XRAY_N)
    traffic = pipe_traffic([], [], corpus)
    n = len(traffic["payloads"])
    tmp = tempfile.mkdtemp(prefix="xray_", dir=os.path.join(REPO, "build"))
    runs = []
    try:
        say(f"xray (13) host cost a call: {xray_host_costs(tmp)} [{card}]")
        for i, on in enumerate(XRAY_ARMS):
            xdir = os.path.join(tmp, f"autopsies{i}")
            res, launches = pipeline_run(
                torch, card, f"xray (x) first {XRAY_N} payloads, xray "
                f"{'on' if on else 'off'}", traffic, "greedy", batch,
                depth=XRAY_DEPTH, wksp_sz=TILE_WKSP,
                verify_opts=dict(FEED_OPTS), feed=True, feed_proc=True,
                sentinel=dict(XRAY_SENTINEL),
                xray={"dir": xdir} if on else False, live=xray_live)
            if on:
                problems = xray_on_problems(res, res.live, xdir, n)
                say(f"  xray waterfall: {xray_waterfall_line(res)}")
            else:
                q = res.live["queue"]
                problems = [f"xray off, yet {what}" for what, bad in (
                    ("a summary", res.xray is not None),
                    ("an autopsy", os.path.exists(xdir)),
                    ("queue rows", any(r["dwell"]["n"] or r["stall_cnt"]
                                       or r["depth_samples"] or r["idle_ns"]
                                       for r in q.values()))) if bad]
            if problems:
                fail(f"xray run {i} ({'on' if on else 'off'}): "
                     + "; ".join(problems))
            say(f"  launches {launches}; sentinel alerts "
                f"{[a['slo'] for a in (res.slo or {}).get('alerts', ())]}")
            runs.append((on, res))

        # (l-xray): the heartbeat question.
        ldir = os.path.join(tmp, "autopsies_l")
        lt = pipe_traffic([], [], bench)
        res, launches = pipeline_run(
            torch, card, f"xray (l-xray) ladder B={LADDER_B}, sched on, "
            "xray on, worker processes", lt, "greedy", LADDER_B,
            verify_opts=dict(FEED_OPTS, sched=True), feed=True,
            feed_proc=True, xray={"dir": ldir})
        halt, alerts = _autopsies(ldir)
        if len(halt) != 1:
            fail(f"xray (l-xray): {len(halt)} HALT autopsies")
        q = halt[0]["queue"]
        hb = [a.get("tiles", []) for a in res.slo["alerts"]
              if a["slo"] == "tile_heartbeat"]
        first = {a["reason"]: (a["suspects"] or [{}])[0].get("stage")
                 for a in alerts}
        vs = res.verify_stats[0]
        say(f"xray (l-xray): verify -> dedup credit stall "
            f"{q['verify_dedup']['stall_ns'] / 1e6:.1f} ms in "
            f"{q['verify_dedup']['stall_cnt']} stalls (mean "
            f"{q['verify_dedup']['stall_ns'] / max(1, q['verify_dedup']['stall_cnt']) / 1e6:.2f} ms); "
            f"stall by edge (ms, count) " + ", ".join(
                f"{e} {q[e]['stall_ns'] / 1e6:.1f}/{q[e]['stall_cnt']}"
                for e in XRAY_LINKS)
            + f"; tile_heartbeat alerts {len(hb)} (tiles {hb}); alert "
            f"autopsies' first suspects {first}; HALT's first suspect "
            f"{(halt[0]['suspects'] or [{}])[0]}; rung_hist "
            f"{vs['rung_hist']}, batches {vs['batches']}; run "
            f"{res.elapsed_s:.1f} s; launches {launches} [{card}]")
        say(f"  xray (l-xray) waterfall: {xray_waterfall_line(res)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def line(r):
        return (f"{n / r.span_s:.0f} txn/s p50 {r.latency_p50_ns / 1e6:.1f} "
                f"p99 {r.latency_p99_ns / 1e6:.1f} ms")

    say("xray (13) off/on in turns: " + "; ".join(
        f"{'on' if on else 'off'} {line(r)}" for on, r in runs)
        + f" [{card}]")
    mean = {a: np.mean([n / r.span_s for on, r in runs if on == a])
            for a in (False, True)}
    say(f"xray (13): mean txn/s off {mean[False]:.0f}, on {mean[True]:.0f}"
        f" (on/off {mean[True] / mean[False]:.3f}); the phase "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


def soak_heap_growth(before, after, dt_s: float, top: int = 6) -> str:
    """The traced heap's largest growth between two tracemalloc
    snapshots, by source line, in KiB a minute."""
    stats = after.compare_to(before, "lineno")[:top]
    return "; ".join(
        f"{s.traceback[0].filename.rsplit('/', 1)[-1]}:"
        f"{s.traceback[0].lineno} {s.size_diff / 1024 / dt_s * 60:.0f} "
        f"KiB/min ({s.count_diff} blocks)" for s in stats)


def soak_half(torch, card, label, plan, payloads, batch, *, chaos=None,
              controller=None):
    """One run_soak of phase 14 on the card (verify mode direct at batch,
    the drain on, SOAK_SENTINEL, the probe every SOAK_PROBE_MS). With
    chaos (an injector) every tile runs in process; with a controller a
    timer sends this process SIGHUP SOAK_SWAP_AT_S seconds after the
    tiles start. Returns (record, result, launches, facts): facts holds
    the verify tile, the batches dispatched before the swap and the
    warm passes in the run."""
    import signal
    import threading
    import tracemalloc

    from firedancer_tpu_torch.disco import soak
    from firedancer_tpu_torch.disco.engine import registry
    from firedancer_tpu_torch.ops import backend

    reg = registry()
    warms0 = {e: e.warms for e in reg.entries()}
    facts = {"at_swap": None, "heap": ""}
    timers = []
    snaps = []

    def hook(v):
        facts["tile"] = v
        apply = v._apply_reconfig

        def applied():
            pending = v._reconfig_pending is not None
            n = v.stat_batches
            apply()
            if pending and v._reconfig_pending is None:
                facts["at_swap"] = n

        v._apply_reconfig = applied
        if controller is not None:
            timers.append(threading.Timer(
                SOAK_SWAP_AT_S, os.kill, (os.getpid(), signal.SIGHUP)))
        # Two heap snapshots: where the probe's fit starts, and near the
        # end of the scripted window.
        for frac in (0.25, 0.9):
            timers.append(threading.Timer(
                frac * plan.duration_s,
                lambda: snaps.append((time.perf_counter(),
                                      tracemalloc.take_snapshot()))))
        for t in timers:
            t.daemon = True
            t.start()

    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    # Started here, so the snapshots see it; run_soak leaves it running.
    tracemalloc.start()
    # SIGHUP reaches the controller for the whole half: run_soak installs
    # its handler over this one and puts this one back.
    old_hup = signal.signal(signal.SIGHUP, lambda *_: (
        controller.trigger() if controller is not None else None))
    try:
        torch.cuda.synchronize()
        backend.reset_counts()
        rec, res = soak.run_soak(
            plan, payloads=payloads, verify_backend="gpu",
            verify_batch=batch, controller=controller,
            timeout_s=SOAK_TIMEOUT_S, record_digests=True,
            verify_opts={"verify_mode": "direct"},
            chaos=chaos, sentinel=SOAK_SENTINEL,
            options=soak.SoakOptions(probe_ms=SOAK_PROBE_MS),
            tile_hook=hook)
        idle_by = time.perf_counter() + 120.0
        while not reg.prewarm_idle() and time.perf_counter() < idle_by:
            time.sleep(0.01)
        torch.cuda.synchronize()
        launches, plain = dict(backend.launches), dict(backend.plain_calls)
    finally:
        for t in timers:
            t.cancel()
        signal.signal(signal.SIGHUP, old_hup)
        tracemalloc.stop()
    mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    facts["warmed"] = {e.key: (e.spec.mode, e.warms - warms0.get(e, 0))
                       for e in reg.entries() if e.warms > warms0.get(e, 0)}
    facts["plain"] = plain
    if len(snaps) == 2:
        facts["heap"] = soak_heap_growth(snaps[0][1], snaps[1][1],
                                         snaps[1][0] - snaps[0][0])
    vs = res.verify_stats[0]
    say(f"{label}: {rec['continuity']['received']} of "
        f"{len(payloads)} payloads at the sink in {res.span_s:.3f} s from "
        f"the first publish = {len(payloads) / res.span_s:.0f} txn/s "
        f"offered through (host clock; run {res.elapsed_s:.3f} s); latency "
        f"p50 {res.latency_p50_ns / 1e6:.3f} ms, p99 "
        f"{res.latency_p99_ns / 1e6:.3f} ms [{card}]")
    for ph in rec["phases"]:
        say(f"{label}: {ph['phase']} (chaos {ph['chaos']}): offered "
            f"{ph['offered_tps']} txn/s, published {ph['published']} in "
            f"{ph['duration_s']} s = "
            f"{ph['published'] / max(ph['duration_s'], 1e-9):.1f} txn/s, "
            f"alerts {ph['alerts']} [{card}]")
    sl = rec["slopes"]
    say(f"{label}: slopes over {sl['samples']} samples: heap "
        f"{sl['heap_kb_min']} KiB/min, pool {sl['pool_milli_min']} "
        f"milli-slots/min, compile {sl['compile_per_hr']}/h (budgets "
        f"{sl['budgets']}, within {sl['within_budget']}); ring_hwm "
        f"{sl['ring_hwm']}; {vs['batches']} batches (fill "
        f"{vs['fill_ratio']}), rlc fallbacks {vs['rlc_fallback']}, drain "
        f"batches {vs['drain_batches']}; alerts "
        f"{[a['slo'] for a in rec['slo']['alerts']]}, explained "
        f"{rec['slo']['explained']} [{card}]")
    say(f"{label}: the traced heap's largest growth: "
        f"{facts['heap'] or 'not measured (no snapshots)'} [{card}]")
    say(f"{label}: device memory allocated {mem0[0]} -> {mem1[0]} B, "
        f"reserved {mem0[1]} -> {mem1[1]} B (torch.cuda) [{card}]")
    return rec, res, launches, facts


def soak_problems(label, rec, res, launches, facts) -> list:
    """The gates both halves share: 4 phases logged, nothing dropped or
    leaked, the slopes armed and within budget, judged ok and valid, no
    plain version, no warm pass of an rlc engine, no healing counter."""
    from firedancer_tpu_torch.disco import sentinel
    from firedancer_tpu_torch.tools import bench_log_check

    problems = []
    if len(rec["phases"]) != SOAK_PHASES:
        problems.append(f"{len(rec['phases'])} phases logged")
    for key in ("dropped", "slots_leaked"):
        if rec["continuity"][key]:
            problems.append(f"{key} {rec['continuity'][key]}")
    if rec["slopes"]["samples"] < sentinel.MIN_SLOPE_SAMPLES:
        problems.append(f"slopes not armed: {rec['slopes']['samples']} "
                        "samples")
    if not rec["slopes"]["within_budget"]:
        problems.append(f"a slope over budget: {rec['slopes']}")
    if not rec["ok"]:
        problems.append(f"judged not ok: {rec['failures']}")
    errs = bench_log_check.validate_soak(rec)
    if errs:
        problems.append(f"validate_soak: {errs}")
    if facts["plain"]:
        problems.append(f"plain versions ran: {facts['plain']}")
    if any(mode != "direct" for mode, _ in facts["warmed"].values()):
        problems.append(f"an rlc warm in the run: {facts['warmed']}")
    return problems + healing_problems(res.verify_stats)


def soak_want_launches(vs, at_swap: int, warmed: dict) -> dict:
    """A soak half's launches: the direct rows once a batch before the
    swap (at_swap; all of them without one) and once an rlc fallback,
    the fused pass once a batch after it, dedup_filter once a batch, and
    a direct batch's for each direct warm in the run."""
    rlc_b = vs["batches"] - at_swap
    want = {k: at_swap + vs["rlc_fallback"] for k in DIRECT_KERNELS}
    for k, n in {**FRONT_LAUNCHES["fused"], **RLC_PASS}.items():
        want[k] = n * rlc_b
    want["dedup_filter"] = vs["drain_batches"]
    for _, n in warmed.values():
        for k in DIRECT_KERNELS:
            want[k] += n
    return {k: v for k, v in want.items() if v}


def soak_phase(torch, card, rows, batch: int = B) -> None:
    """Phase 14: fd_soak on the card (scripts/soak_smoke.py). The plan
    (SOAK_SEED, SOAK_PHASES, SOAK_PHASE_S, SOAK_RATE) signed on the card;
    the soak half (the plan's chaos, a SIGHUP swap to SOAK_REQUEST at
    SOAK_SWAP_AT_S) and the control half (neither) on the same payloads
    at batch, each judged by run_soak; every gate fatal. Adds the
    phase's launches (the corpora's signing and both halves) to rows and
    writes both records under build/soak/."""
    import tempfile
    import threading

    from firedancer_tpu_torch.disco import chaos as chaos_mod
    from firedancer_tpu_torch.disco import soak
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.disco.feed import runtime
    from firedancer_tpu_torch.ops import backend
    from firedancer_tpu_torch.ops.dedup_filter import DEFAULT_FILTER_BITS
    from firedancer_tpu_torch.tools import fd_soak

    t_phase = time.perf_counter()
    # Threads that other phases left would take the GIL from the soak
    # half's tiles.
    say(f"soak: {threading.active_count()} threads alive at the start: "
        f"{sorted(t.name for t in threading.enumerate())}")
    reg = registry()
    direct = EngineSpec("direct", batch)
    rlc = EngineSpec.for_tile("gpu", "rlc", batch, SOAK_REQUEST["frontend"])
    # Both engines and filters warm before the runs: a warm inside the
    # window would land in the heap and compile-cache slopes.
    for spec in (direct, rlc):
        reg.acquire(spec)[0].warm_drain(DEFAULT_FILTER_BITS)

    plan = soak.build_plan(seed=SOAK_SEED, n_phases=SOAK_PHASES,
                           phase_s=SOAK_PHASE_S, rate=SOAK_RATE)
    classes = sorted({ph.chaos for ph in plan.phases if ph.chaos})
    if classes != sorted(SOAK_CLASSES):
        fail(f"soak plan: chaos classes {classes}, want {SOAK_CLASSES}")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    backend.reset_counts()
    payloads = soak.build_payloads(plan)
    torch.cuda.synchronize()
    sign_launches = dict(backend.launches)
    if backend.plain_calls:
        fail(f"soak corpora: plain versions ran {dict(backend.plain_calls)}")
    say(f"soak plan: seed {plan.seed}, {len(payloads)} payloads signed on "
        f"the card in {time.perf_counter() - t0:.1f} s (launches "
        f"{sign_launches}), scripted {plan.duration_s:.1f} s a half; "
        f"chaos {plan.chaos_schedule!r}")
    for ph in plan.phases:
        say(f"soak plan: {ph.name}: profile {ph.profile}, chaos "
            f"{ph.chaos}, {ph.rate:.1f} txn/s, n {ph.n_txns} "
            f"[{ph.start_idx}, {ph.end_idx}), {ph.n_unique_ok} unique ok")

    tmp = tempfile.mkdtemp(prefix="soak_", dir=os.path.join(REPO, "build"))
    req_path = os.path.join(tmp, "reconfig.json")
    with open(req_path, "w", encoding="utf-8") as f:
        json.dump(SOAK_REQUEST, f)
    controller = soak.ReconfigController(path=req_path, poll_s=0.1)
    inj = chaos_mod.injector(soak.chaos_spec(plan))
    try:
        rec, res, launches, facts = soak_half(
            torch, card, "soak (chaos, swap)", plan, payloads, batch,
            chaos=inj, controller=controller)
        # The swap retired the direct entry: warm it again for the
        # control, outside its counts.
        reg.acquire(direct)[0].warm_drain(DEFAULT_FILTER_BITS)
        ctl_rec, ctl_res, ctl_launches, ctl_facts = soak_half(
            torch, card, "soak control", plan, payloads, batch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    v, vs = facts["tile"], res.verify_stats[0]
    ctl_vs = ctl_res.verify_stats[0]
    passes = {k.split(":", 1)[1]: n for k, n in sorted(inj._ord.items())
              if k.startswith("housekeep:")}
    counters = inj.snapshot()["counters"]
    say(f"soak (chaos, swap): housekeeping passes by tile {passes}; "
        f"chaos counters {counters}; controller log "
        f"{[(e['ok'], e['detail']) for e in controller.log]}; swap after "
        f"{facts['at_swap']} of {vs['batches']} batches, mode now "
        f"{v.verify_mode} on {v._engine_entry.key} [{card}]")
    problems = soak_problems("soak", rec, res, launches, facts)
    if rec["slo"]["unexplained_alerts"]:
        problems.append(f"unexplained alerts: {rec['slo']['alerts']}")
    for cls in SOAK_CLASSES:
        c = counters.get(cls, {})
        if cls not in rec["slo"]["explained"] or not (
                c.get("injected") == c.get("detected") == c.get("healed")
                and c.get("injected", 0) >= 1):
            problems.append(f"{cls}: {c}, explained "
                            f"{rec['slo']['explained']}")
    if (rec["reconfig"]["applied"], rec["reconfig"]["refused"]) != (1, 0):
        problems.append(f"reconfig trail {rec['reconfig']}")
    at_swap = facts["at_swap"]
    if at_swap is None or not 0 < at_swap < vs["batches"]:
        problems.append(f"swap after {at_swap} of {vs['batches']} batches")
        at_swap = at_swap or 0
    if (v.verify_mode, v._engine_entry.spec) != ("rlc", rlc):
        problems.append(f"after the swap: mode {v.verify_mode}, engine "
                        f"{v._engine_entry.key}")
    want = soak_want_launches(vs, at_swap, facts["warmed"])
    if launches != want or vs["drain_batches"] != vs["batches"]:
        problems.append(f"launches {launches} != {want} (drain batches "
                        f"{vs['drain_batches']} of {vs['batches']})")
    match = (collections.Counter(res.sink_digests)
             == collections.Counter(ctl_res.sink_digests))
    rec["continuity"]["digest_match"] = match
    if not match:
        rec["ok"] = False
        rec["failures"].append(
            "sink digest multiset diverged from the no-reconfig control")
        problems.append(f"digest multiset: {len(res.sink_digests)} vs the "
                        f"control's {len(ctl_res.sink_digests)}")
    problems += [f"control: {p}" for p in soak_problems(
        "control", ctl_rec, ctl_res, ctl_launches, ctl_facts)]
    if ctl_rec["slo"]["alert_cnt"]:
        problems.append(f"control alerts: {ctl_rec['slo']['alerts']}")
    ctl_want = soak_want_launches(ctl_vs, ctl_vs["batches"],
                                  ctl_facts["warmed"])
    if ctl_launches != ctl_want:
        problems.append(f"control launches {ctl_launches} != {ctl_want}")
    if ("workers" in ctl_res.proc_cpu_s) != (runtime.usable_cores() >= 4):
        problems.append(f"control layout: {ctl_res.proc_cpu_s}")

    os.makedirs(fd_soak.OUT_DIR, exist_ok=True)
    paths = []
    for r in (rec, ctl_rec):
        path = fd_soak.next_artifact_path(fd_soak.OUT_DIR)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(r, f, indent=1, sort_keys=True)
            f.write("\n")
        paths.append(os.path.relpath(path, REPO))
    for part in (sign_launches, launches, ctl_launches):
        for name, n in part.items():
            for row in TAILS_ROWS if name == "msm_tails" else (name,):
                if row in rows:
                    rows[row]["launches"] += n
    say(f"soak: launches, signing {sign_launches}, soak half {launches}, "
        f"control {ctl_launches}; digests {len(res.sink_digests)} equal "
        f"to the control's: {match}; records {paths} [{card}]")
    say(f"soak: the phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    if problems:
        fail("soak: " + "; ".join(problems))
    say(f"soak: judged ok twice, 0 unexplained alerts, {SOAK_CLASSES} "
        "injected = detected = healed, 1 swap to fused rlc applied at "
        f"B = {batch}, the sink's digests equal the control's, slopes "
        "armed within budget, no plain version")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run "
              "needs a CUDA device", flush=True)
        return 2
    sys.path.insert(0, REPO)
    from firedancer_tpu_torch import convert
    from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops import backend, build
    from firedancer_tpu_torch.ops import curve_cuda, dsm_cuda, fe25519
    from firedancer_tpu_torch.ops import frontend_cuda
    from firedancer_tpu_torch.ops.verify import verify_batch_ref

    # 1. Card.
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    kind = torch.cuda.get_device_name(0)
    say(f"card: {card}; capability {cap[0]}.{cap[1]}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    if cap[0] != 9:
        fail(f"need compute capability 9.x, found {cap}")
    dev = torch.device("cuda", 0)

    # 2. Build: the ring library (make -C native) beside the kernels.
    import threading

    from firedancer_tpu_torch.tango import rings

    t0 = time.perf_counter()
    native_err = []

    def build_native():
        try:
            rings.ensure_native_built()
            rings.require_drain()
        except Exception as e:  # noqa: BLE001 - failed below
            native_err.append(e)

    native = threading.Thread(target=build_native)
    native.start()
    build.build_all()
    native.join()
    if native_err:
        fail(f"native ring library: {native_err[0]!r}")
    say(f"build: {time.perf_counter() - t0:.2f} s "
        f"(stamp {build.stamp()}, {build.BUILD_DIR}; {rings.LIB_PATH})")
    for name in build.ptxas_report():
        say(f"ptxas {name}: {ptxas_line(build, name)}")
    sass_loops(build)

    rng = np.random.RandomState(7)

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def parity(name, got, want):
        err = max_abs_err(torch, got, want)
        if err != 0:
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max_abs_err {err})")
        return err

    rows = {}

    def record(name, err, ms, plain_ms, bound, replaces, source):
        rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}
        say(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), max_abs_err {err}")

    # 3. Kernel parity and times at the main path's shapes.
    # K1: the main path's hash rows r || A || msg, (8192, 64 + 192); rows
    # of every length 0-1296; stride 1299; rows at an odd base address;
    # each also at the ragged n of HASH_RAGGED.
    k1_msgs = gpu(rng.randint(0, 256, (B, 64 + MSG_LEN), dtype=np.uint8))
    k1_lens = torch.full((B,), 64 + MSG_LEN, dtype=torch.int32, device=dev)
    spread = rng.randint(0, 64 + MTU_MSG + 1, B).astype(np.int32)
    spread[:6] = [0, 111, 112, 239, 240, 64 + MTU_MSG]
    s_msgs = gpu(rng.randint(0, 256, (B, 64 + MTU_MSG), dtype=np.uint8))
    s_lens = gpu(spread)
    extra_rows = hash_rows(torch, gpu, dev)
    k1_shapes = [("256-byte rows", (k1_msgs, k1_lens)),
                 ("lengths 0-1296", (s_msgs, s_lens)), *extra_rows.items()]
    err = hash_shapes(parity, "sha512_mod_l", k1_shapes,
                      frontend_cuda.sha512_mod_l_cuda,
                      frontend_cuda.sha512_mod_l_ref)
    say(f"sha512_mod_l: equal on {', '.join(k for k, _ in k1_shapes)}, "
        f"each at B and n = {', '.join(map(str, HASH_RAGGED))}")
    check_no_stack(build, "sha512_mod_l")
    record("sha512_mod_l", err,
           hash_timed(torch, "sha512_mod_l",
                      lambda: frontend_cuda.sha512_mod_l_cuda(
                          k1_msgs, k1_lens), "sha512_mod_l_kernel"),
           time_ms(torch, lambda: frontend_cuda.sha512_mod_l_ref(
               k1_msgs, k1_lens), 2),
           bound_sha512_mod_l(np.full(B, 64 + MSG_LEN), 64 + MSG_LEN),
           "firedancer_tpu/ops/frontend_pallas.py:290",
           "firedancer_tpu_torch/ops/csrc/sha512_mod_l.cu")

    # K2: the stacked A || R pass, 2B lanes: the edge corpus, then random
    # bytes (about half decode); then ragged shapes, cut where edges meet
    # random lanes; timed at B, 2B and 4B lanes.
    edge = corpus.edge_encodings(rng)
    k2_np = rng.randint(0, 256, (4 * B, 32), dtype=np.uint8)
    k2_np[:len(edge)] = np.frombuffer(b"".join(edge), np.uint8).reshape(-1, 32)
    enc4 = gpu(k2_np)
    enc = enc4[:2 * B]
    k2 = curve_cuda.decompress_so_cuda(enc)
    err = parity("decompress_so", k2, curve_cuda.decompress_so_ref(enc))
    torsion = len(corpus.torsion_encodings())
    if not (bool(k2[2][:torsion].all()) and bool(k2[1][:torsion].all())):
        fail("decompress_so: a torsion encoding is not decoded small-order")
    ragged = [(len(edge) - 3, n) for n in RAGGED] + [(0, 2 * B - 3)]
    for off, n in ragged:
        cut = enc[off:off + n]
        err = max(err, parity(f"decompress_so ({n} lanes)",
                              curve_cuda.decompress_so_cuda(cut),
                              curve_cuda.decompress_so_ref(cut)))
    say(f"decompress_so: {int(k2[1].sum())}/{2 * B} lanes decode, "
        f"{len(edge)} edge encodings; equal at n = "
        f"{', '.join(str(n) for _, n in ragged)}")
    for lanes in (B, 2 * B, 4 * B):
        k_ms = time_ms(torch, lambda: curve_cuda.decompress_so_cuda(
            enc4[:lanes]), REPS)
        say(f"  decompress_so at {lanes} lanes: {k_ms:.4f} ms, "
            f"{k_ms * 1e6 / lanes:.2f} ns a lane, bound "
            f"{bound_decompress_so(lanes)[0]:.4f} ms")
    say(f"decompress_so resources: {ptxas_line(build, 'decompress_so')}")
    record("decompress_so", err,
           time_ms(torch, lambda: curve_cuda.decompress_so_cuda(enc), REPS),
           time_ms(torch, lambda: curve_cuda.decompress_so_ref(enc), 2),
           bound_decompress_so(2 * B),
           "firedancer_tpu/ops/curve_pallas.py:234",
           "firedancer_tpu_torch/ops/csrc/decompress_so.cu")

    # K3: B decoded points (ok lanes, repeated), random h and s.
    ok_idx = torch.nonzero(k2[1]).flatten()
    a_pt = k2[0][ok_idx[torch.arange(B, device=dev) % ok_idx.numel()]]
    a_pt = a_pt.contiguous()
    h = gpu(rng.randint(0, 256, (B, 32), dtype=np.uint8))
    s = gpu(rng.randint(0, 256, (B, 32), dtype=np.uint8))
    k3 = dsm_cuda.double_scalarmult_cuda(h, a_pt, s)
    err = parity("double_scalarmult", k3,
                 dsm_cuda.double_scalarmult_ref(h, a_pt, s))
    err = max(err, parity("double_scalarmult (affine)",
                          convert.point_to_affine_bytes(k3[:512]),
                          convert.point_to_affine_bytes(
                              dsm_cuda.double_scalarmult_ref(
                                  h[:512], a_pt[:512], s[:512]))))
    record("double_scalarmult", err,
           time_ms(torch, lambda: dsm_cuda.double_scalarmult_cuda(
               h, a_pt, s), REPS),
           time_ms(torch, lambda: dsm_cuda.double_scalarmult_ref(
               h, a_pt, s), 2),
           bound_double_scalarmult(B),
           "firedancer_tpu/ops/dsm_pallas.py:252",
           "firedancer_tpu_torch/ops/csrc/double_scalarmult.cu")
    k3_edges(torch, gpu, parity, a_pt, h, s)
    info = dsm_cuda.kernel_info()
    say(f"double_scalarmult resources: {info['threads']} threads (32 "
        f"lanes) a block, {info['registers']} registers and "
        f"{info['stack_bytes']} B of stack a thread, "
        f"{info['static_shared_bytes'] + info['dynamic_shared_bytes']} B of "
        f"shared memory a block ({info['dynamic_shared_bytes']} B A "
        f"columns + {info['static_shared_bytes']} B B table), "
        f"{info['blocks_per_sm']} blocks an SM; ptxas above gives spills")

    # K4: affine points against projective (x Z : y Z : Z) of six kinds,
    # about half of the lanes equal (point_eq_inputs); B lanes for the
    # row, then the ragged n and coordinate counts (point_eq_parity).
    lam = fe25519.fe_from_bytes(gpu(rng.randint(0, 256, (B, 32),
                                                dtype=np.uint8)))
    # The swap mask's draw, which point_eq_inputs no longer takes from
    # rng: it keeps the inputs of the phases below those of earlier trees,
    # so an A/B against them times the same data.
    rng.randint(0, 2, B)
    aff4, proj3 = point_eq_inputs(torch, gpu, a_pt, lam)
    aff, proj = aff4[:B], proj3[:B]
    k4 = curve_cuda.point_eq_affine_cuda(aff, proj)
    err = parity("point_eq", k4, curve_cuda.point_eq_affine_ref(aff, proj))
    say(f"point_eq: {int(k4.sum())}/{B} lanes equal")
    if not 0.4 * B < int(k4.sum()) < 0.6 * B:
        fail("point_eq: expected about half of the lanes equal")
    point_eq_parity(torch, parity, aff4, proj3)
    check_no_stack(build, "point_eq")

    def k4_fn():
        return curve_cuda.point_eq_affine_cuda(aff, proj)

    k4_ms = time_ms(torch, k4_fn, REPS)
    say(f"  point_eq {B} lanes: kernel {k4_ms:.4f} ms"
        f"{_device_note(torch, k4_fn, 'point_eq_kernel')}")
    record("point_eq", err, k4_ms,
           time_ms(torch, lambda: curve_cuda.point_eq_affine_ref(aff, proj),
                   2),
           bound_point_eq(B),
           "firedancer_tpu/ops/curve_pallas.py:296",
           "firedancer_tpu_torch/ops/csrc/point_eq.cu")

    # The RLC front half's kernels. frontend_rlc and sha512_batch on the
    # main path's hash rows and on rows of every length; z < 2^126 as
    # fresh_z draws it, zero on dead lanes, and s of any 32 bytes.
    z_np = rng.randint(0, 256, (B, 32), dtype=np.uint8)
    z_np[:, 16:] = 0
    z_np[:, 15] &= 0x3F
    z_np[::97] = 0
    fz, fs = gpu(z_np), gpu(rng.randint(0, 256, (B, 32), dtype=np.uint8))
    # z and s at odd addresses: the kernel's byte path for its scalars.
    fz_odd, fs_odd = (gpu(np.concatenate([np.zeros(1, np.uint8),
                                          t.cpu().numpy().ravel()]))[1:]
                      .view(B, 32) for t in (fz, fs))
    rlc_shapes = [(label, (m, ln, fz, fs)) for label, (m, ln) in k1_shapes]
    rlc_shapes.append(("lengths 0-1296, z and s at odd addresses",
                       (s_msgs, s_lens, fz_odd, fs_odd)))
    err = hash_shapes(parity, "frontend_rlc", rlc_shapes,
                      frontend_cuda.frontend_rlc_cuda,
                      frontend_cuda.frontend_rlc_ref)
    say(f"frontend_rlc: equal on {', '.join(k for k, _ in rlc_shapes)}, "
        f"each at B and n = {', '.join(map(str, HASH_RAGGED))}")
    check_no_stack(build, "frontend_rlc")
    record("frontend_rlc", err,
           hash_timed(torch, "frontend_rlc",
                      lambda: frontend_cuda.frontend_rlc_cuda(
                          k1_msgs, k1_lens, fz, fs), "frontend_rlc_kernel"),
           time_ms(torch, lambda: frontend_cuda.frontend_rlc_ref(
               k1_msgs, k1_lens, fz, fs), 2),
           bound_frontend_rlc(np.full(B, 64 + MSG_LEN), 64 + MSG_LEN),
           "firedancer_tpu/ops/frontend_pallas.py:319",
           "firedancer_tpu_torch/ops/csrc/frontend_rlc.cu")
    # sha512_batch on K1's shapes and signing's 32- and 224-byte rows
    # (its 1344-byte rows in sign_kernel_parity).
    sb_shapes = [*k1_shapes, *sign_hash_rows(torch, gpu, dev)]
    err = hash_shapes(parity, "sha512_batch", sb_shapes,
                      frontend_cuda.sha512_batch_cuda,
                      frontend_cuda.sha512_batch_ref)
    say(f"sha512_batch: equal on {', '.join(k for k, _ in sb_shapes)}, "
        f"each at B and n = {', '.join(map(str, HASH_RAGGED))}")
    check_no_stack(build, "sha512_batch")
    record("sha512_batch", err,
           hash_timed(torch, "sha512_batch",
                      lambda: frontend_cuda.sha512_batch_cuda(
                          k1_msgs, k1_lens), "sha512_batch_kernel"),
           time_ms(torch, lambda: frontend_cuda.sha512_batch_ref(
               k1_msgs, k1_lens), 2),
           bound_sha512_batch(np.full(B, 64 + MSG_LEN), 64 + MSG_LEN),
           "firedancer_tpu/ops/sha512_pallas.py:220",
           "firedancer_tpu_torch/ops/csrc/sha512_batch.cu")

    # decompress_niels on 2B encodings: random bytes (about half decode),
    # the edge corpus spread over the first B lanes (y = +-1, non-square,
    # non-canonical and small-order lanes among valid ones; the plain
    # version's 32-lane inversion groups mix them) and one whole group of
    # undecodable encodings at lane B; then the ragged shapes.
    dn_np = rng.randint(0, 256, (2 * B, 32), dtype=np.uint8)
    spots = np.linspace(5, B - 1, len(edge)).astype(np.int64)
    dn_np[spots] = np.frombuffer(b"".join(edge), np.uint8).reshape(-1, 32)
    dn_np[B:B + 32] = np.frombuffer(b"".join(
        corpus.undecodable_encodings(32, rng)), np.uint8).reshape(-1, 32)
    dn_enc = gpu(dn_np)
    dn = curve_cuda.decompress_niels_cuda(dn_enc)
    err = parity("decompress_niels", dn,
                 curve_cuda.decompress_niels_ref(dn_enc))
    for off, n in [(int(spots[3]), n) for n in RAGGED] + [(0, 2 * B - 3)]:
        cut = dn_enc[off:off + n]
        err = max(err, parity(f"decompress_niels ({n} lanes)",
                              curve_cuda.decompress_niels_cuda(cut),
                              curve_cuda.decompress_niels_ref(cut)))
    err = max(err, parity("decompress_niels points vs decompress_so",
                          dn[:3], curve_cuda.decompress_so_cuda(dn_enc)))
    t_spots = gpu(spots[:torsion])
    if not (bool(dn[2][t_spots].all()) and bool(dn[1][t_spots].all())
            and not bool(dn[1][B:B + 32].any())):
        fail("decompress_niels: a torsion encoding is not decoded "
             "small-order, or an undecodable lane decoded")
    say(f"decompress_niels: {int(dn[1].sum())}/{2 * B} lanes decode, "
        f"{len(edge)} edge encodings spread, one failing group; equal at "
        f"n = {', '.join(str(n) for n in RAGGED)} and {2 * B - 3}")
    say(f"decompress_niels resources: "
        f"{ptxas_line(build, 'decompress_niels')}")
    record("decompress_niels", err,
           time_ms(torch, lambda: curve_cuda.decompress_niels_cuda(dn_enc),
                   REPS),
           time_ms(torch, lambda: curve_cuda.decompress_niels_ref(dn_enc),
                   2),
           bound_decompress_niels(2 * B),
           "firedancer_tpu/ops/curve_pallas.py:234",
           "firedancer_tpu_torch/ops/csrc/decompress_niels.cu")

    sign_kernel_parity(torch, gpu, parity, record, rng)
    check_no_stack(build, "fe_pow")
    check_no_stack(build, "compress")
    sc_grid_parity(torch, parity, dev)
    check_no_stack(build, "sc_reduce")

    # Traffic (oracle signing on the host), for phases 3 to 5.
    t0 = time.perf_counter()
    bench_rng = np.random.RandomState(42)
    uniq = corpus.signed_items(64, [MSG_LEN], bench_rng)
    tiled = [uniq[b % 64] for b in range(B)]
    batch_a = corpus.to_arrays(tiled, MSG_LEN)
    expect_a = np.zeros(B, np.int32)

    fixtures = os.path.join(REPO, "tests", "fixtures")
    zcash = []
    for fname, passes in (("ed25519_malleability_should_pass.bin", True),
                          ("ed25519_malleability_should_fail.bin", False)):
        raw = open(os.path.join(fixtures, fname), "rb").read()
        zcash += [(raw[o:o + 64], raw[o + 64:o + 96], passes)
                  for o in range(0, len(raw), 96)]
    if len(zcash) != 396:
        fail(f"expected 396 Zcash vectors, found {len(zcash)}")
    bad_pub = corpus.undecodable_encodings(1, bench_rng)[0]
    items_b, expect_b, zcash_pass = [], np.zeros(B, np.int32), {}
    for b in range(B):
        m, sig, pub = tiled[b]
        if b < len(zcash):
            sig, pub, passes = zcash[b]
            m = b"Zcash"
            zcash_pass[b] = passes
        elif b % 64 == 1:        # s + L: the same scalar, out of range
            s_int = int.from_bytes(sig[32:], "little") + oracle.L
            sig = sig[:32] + s_int.to_bytes(32, "little")
            expect_b[b] = oracle.FD_ED25519_ERR_SIG
        elif b % 64 == 2:
            pub = bad_pub
            expect_b[b] = oracle.FD_ED25519_ERR_PUBKEY
        elif b % 8 == 3:         # salted: one message byte flipped
            m = bytes([m[0] ^ 1]) + m[1:]
            expect_b[b] = oracle.FD_ED25519_ERR_MSG
        items_b.append((m, sig, pub))
    batch_b = corpus.to_arrays(items_b, MSG_LEN)

    mtu_lens = list(np.linspace(100, MTU_MSG, 64).astype(int))
    uniq_c = corpus.signed_items(64, mtu_lens, bench_rng)
    batch_c = corpus.to_arrays([uniq_c[b % 64] for b in range(B)], MTU_MSG)
    expect_c = np.zeros(B, np.int32)

    # The RLC torsion batch: (a) with an order-2 pair (lanes 4, 5) and four
    # order-8-offset lanes (6-9) of the RLC corpus; each fails per lane.
    rlc_cases = corpus.rlc_corpus()
    items_t = list(tiled)
    items_t[4:6] = rlc_cases["order2"][4:6]
    items_t[6:10] = rlc_cases["order8"][4:8]
    batch_t = corpus.to_arrays(items_t, MSG_LEN)
    say(f"traffic: {time.perf_counter() - t0:.1f} s of oracle signing")

    msm_parity(torch, gpu, parity, record, batch_a, batch_t)

    # 4. Direct path.
    t0 = time.perf_counter()
    entry, warmed = registry().acquire(EngineSpec("direct", B))
    say(f"engine {entry.key} on {entry.device}: warmed={warmed} "
        f"in {time.perf_counter() - t0:.2f} s")
    batches = [("a bench", batch_a, expect_a), ("b mixed", batch_b, expect_b),
               ("c mtu", batch_c, expect_c)]
    inputs = [tuple(gpu(a) for a in arrs) for _, arrs, _ in batches]
    torch.cuda.synchronize()

    backend.reset_counts()
    outs = [entry.fn(*args) for args in inputs]
    torch.cuda.synchronize()
    launches = dict(backend.launches)
    plain = dict(backend.plain_calls)
    say(f"direct path: launches {launches}, plain calls {plain}")
    for name in DIRECT_KERNELS:
        if launches.get(name, 0) < 1:
            fail(f"{name} was not launched on the direct path")
        rows[name]["launches"] = launches[name]
    if any(plain.values()):
        fail(f"a plain version ran on the direct path: {plain}")

    for (name, _, expect), out, args in zip(batches, outs, inputs):
        got = out.cpu().numpy()
        ref = verify_batch_ref(*args).cpu().numpy()
        if not np.array_equal(got, ref):
            fail(f"batch {name}: statuses differ from the plain path on "
                 f"{int((got != ref).sum())} lanes")
        want = expect.copy()
        if name.startswith("b"):
            for b, passes in zcash_pass.items():
                if passes != (got[b] == 0):
                    fail(f"batch {name}: Zcash vector at lane {b} "
                         f"gave status {got[b]}")
                want[b] = got[b]
        if not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0]
            fail(f"batch {name}: {len(bad)} lanes differ from the "
                 f"constructed statuses, first {bad[:8].tolist()}: "
                 f"{got[bad[:8]].tolist()} vs {want[bad[:8]].tolist()}")
        say(f"batch {name}: {B} lanes match (status counts "
            f"{dict(zip(*np.unique(got, return_counts=True)))})")

    a_args = inputs[0]
    ms = time_ms(torch, lambda: entry.fn(*a_args), TIMED_BATCHES)
    t0 = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        entry.fn(*a_args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED_BATCHES
    entry.note_service(int(wall * 1e9))
    say(f"verify direct B={B} msg={MSG_LEN}: {ms:.3f} ms/batch (CUDA "
        f"events), {B / (ms / 1e3):.0f} verifies/s; host clock "
        f"{wall * 1e3:.3f} ms/batch, {B / wall:.0f} verifies/s "
        f"[{card}]")
    profile_batches(torch, lambda: entry.fn(*a_args), wall * 1e3)
    direct_b = outs[1].cpu().numpy()
    rlc_path(torch, gpu, rows, card, (batch_a, batch_b, batch_t),
             (expect_a, expect_b), direct_b, zcash_pass, entry)
    signing_path(torch, gpu, rows, card)
    traffic = tile_phase(torch, card)
    pack_phase(torch, card, record, *traffic)
    bench = feed_phase(torch, card, rows, record, *traffic)
    app_phase(torch, card)
    chaos_phase(torch, card, batch_b, direct_b)
    late_trace_probe(torch)
    flight_phase(torch, card, bench)
    xray_phase(torch, card, bench)
    soak_phase(torch, card, rows)

    # 15. Output.
    say(card_line())
    say(json.dumps({"kernels": list(rows.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
