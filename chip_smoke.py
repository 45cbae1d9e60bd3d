#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`hotstuff_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and no phase's exception is
caught:
  1. the card line (`nvidia-smi` name, power limit), then build every CUDA
     kernel from `hotstuff_tpu_torch/ops/csrc/` (nvcc, sm_90a); fails when
     ptxas reports spill bytes for either ladder kernel, K3, K4, K2 / K2g,
     K6, K7 or K8, or a stack frame for K6 (the ptxas lines of the tuning
     tool's `hs_field_sqr_n` and `hs_alu_chain` are printed, not gated);
  2. each kernel against its plain PyTorch version on the same CUDA tensors
     at 4,096 lanes, exactly (integer outputs, tolerance 0); K3
     `decompress_table` (raw limbs and valid, on random and special keys),
     K1 `ladder` (raw limbs) and K4 `compress_eq` (the mask, on
     lambda-scaled, identity, non-canonical-R and invalid lanes) also at
     every width of WIDTHS (1, 7, 43, 128, 1,000) and of NODE_BUCKETS (256,
     512, 1,024, 2,048, a node's bulk buckets), all three timed at 128
     lanes beside 4,096; K2 `h_digits` at every width too (the 16-byte
     tile path at 128, NODE_BUCKETS and 4,096, the byte-wide path at the
     others and on rows at a misaligned address), timed at 128 lanes
     beside 4,096;
     then K2's reduction alone (`hs_reduce_mod_l`, a test entry) against
     `reduce_mod_l` and Python ints on the edge values and the 4,096-value
     sweep of tests/test_torch_sha512.py;
  3. the main path: `TorchBackend(device="cuda").verify_batch_mask` on a
     16,384-signature batch (4,096 distinct pysigner signatures over 32-byte
     digests, tiled, ~1/16 of lanes corrupted), chunk 4,096, max_bucket
     8,192; then one host-hash batch (33-byte messages and the RFC 8032
     vectors). Masks must equal the expected masks, which the host verifier
     (`pysigner.verify_device_semantics`, what `HostBackend` runs)
     cross-checks; on the card a device-hash failure raises, so it fails
     the phase. Every batch of phases 3 and 5-7 runs through the
     verifier's dispatch pipeline at its default depth
     (`HOTSTUFF_PIPELINE_DEPTH`, else 2) from page-locked staging buffers
     on two CUDA streams, staged by the native plane
     (`hotstuff_tpu_torch/native/staging.cpp`, built with g++); the phase
     fails unless it is, and unless the batch's chunks were each staged by
     one native call of their form;
  3b. the native staging plane against the numpy staging it stands for,
     on the host, over phase 3's batch and phase 5's votes (made here,
     before the phase): each of the four forms (generic and committee,
     host and device hash) byte for byte (wire rows, pad lanes, s < L
     mask, indices) at shards 1, 2 and 4, in a reused pooled buffer at a
     width above n, over host-hash messages of 0 to 300 bytes (across
     SHA-512's 112-byte padding edge) and with s = L - 1, L and 2^256 - 1;
     then each form's stage ms per 4,096-lane chunk through a native and a
     numpy verifier's `stage_wire`, in turns (median and spread). Fails on
     any difference, never on speed;
  4. launch counts of the main path, end-to-end rate, per-kernel times
     beside the plain versions' and the least time the card could take
     (kernel times are device times of launches queued behind a spin
     kernel, `breakdown.queued_ms`, so the host's launch time stays out);
     then `bench.py --pipeline-ab` on the card: phase 3's batch tiled to
     24,576 lanes (6 chunks) through a depth 1 and a depth 2 verifier in
     turns, 3 attempts of 3 batches each (no early stop), printing per
     leg sigs/s, the device timeline's occupancy and overlap headroom,
     stalls, `pipeline.buffer_allocs` / `buffer_reuse`, and, over one
     traced batch, the `torch.profiler` busy share and the streams the
     kernels and copies ran on, with the staging each leg used. Fails
     when a mask differs from the expected one, when a leg allocates a
     staging buffer after its warm-up, or when the depth 2 leg puts a
     launch or copy on the default stream; never on speed;
  5. the committee path: `TorchBackend.verify_batch_mask(...,
     committee=True)` on a QC-shaped batch as `bench.py --committee-cache`
     builds it (64 validators, 381 QCs x 43 votes = 16,383 votes over
     32-byte digests, 96 distinct QCs signed and tiled, ~1/16 of lanes
     corrupted or voted by three special keys), chunk 4,096. The mask must
     equal the expected mask and the generic path's mask for the same
     batch; K5, K2g and K4 launch 4 times each, K1, K3 and K2 not at all.
     Then a host-hash committee batch, a tagged batch with an unregistered
     key (generic kernels, one miss) and a batch pinned to a replaced
     table; votes/s of the committee and generic paths on the same votes,
     in turns; one committee batch under `torch.profiler` (busy share,
     nothing on the default stream); the host-vs-card break-even of both
     paths (a sweep of batch sizes 1..64 against the exact host verifier
     and against OpenSSL where the `cryptography` wheel is installed: the
     break-evens `TorchBackend`'s defaults on each host route are taken
     from), then `TorchBackend` at its default crossovers (its resolved
     `crossover`, `committee_crossover` and `host_route` printed) on each
     size of the sweep, tagged and untagged, with rejected lanes among
     them: a batch under its path's default must go to the host route (its
     `stats` and `verifier.crossover_fallbacks` move), one at or above it
     to the card, and each must give the card's mask; last, kernels K5
     `committee_ladder` and K2g `h_digits_idx`
     against their plain versions at 4,096 lanes (random indices over the
     67-entry table, a few out of range, a ragged width), exactly; both
     also at every width of WIDTHS and timed at 128 lanes beside 4,096;
  5b. the sharded verifier (`hotstuff_tpu_torch/parallel/mesh.py`) on a mesh
     of every visible GPU and on virtual meshes of 2 and 4 shards on
     `cuda:0`: `TorchBackend(mesh=...)` (chunk 4,096, max_bucket 8,192),
     warmed up, phase 5's table registered, runs phase 3's generic batch
     and phase 5's committee votes. Each mask must equal the expected one
     and the single-device backend's, with 0 host lanes; each kernel must
     launch the shard count times its single-device count (the others 0);
     the registration and every committee batch must count no
     decompression and no table build; the table must have one replica per
     distinct device of the mesh; no staging buffer may be allocated after
     warm-up; one traced generic and one traced committee batch must put
     nothing on the default stream. Each mesh is timed against the
     single-device backend in turns (3 attempts of 3 batches a path;
     medians, busy share of the traced batches, each kernel's device ms at
     the shard width with the bound of their sum). Then
     `sharded_qc_counts` on a virtual 2 x 2 mesh over phase 5's 96 signed
     QCs (each padded to 44 lanes) must give the expected masks and per-QC
     counts, and the sidecar CLI with `--sharded --committee` (every
     visible GPU) must boot and answer one QC with the expected mask;
  5c. the multi-process mesh (`parallel.init_multihost`): two worker
     processes of this script (`--multihost-worker`), rank 0 and rank 1,
     join over gloo on 127.0.0.1, each with a virtual mesh of 2 shards on
     `cuda:0` (a global mesh of 4 entries, the 2 x 2 of
     tests/test_multihost.py), both on the one card. From one file of
     inputs (phase 3's batch, phase 5's votes and table), each rank runs
     `TorchBackend(mesh=...)` on the generic batch and the committee votes
     and a `packed=False` verifier on the batch's first 4,096 lanes. On
     both ranks each mask must equal the one-process backend's of phases 3
     and 5 lane for lane; each rank must launch each kernel of the path
     (K2, K3, K1, K4; K2g, K5, K4; K3, K1, K4) chunks x 2 times, for its own
     2 shards only, and nothing else; each batch must end in exactly one
     gather (`mesh.gathers`). Then 3 timed batches a rank: the gather's ms
     a batch and the two processes' sigs/s beside the one-process
     backend's on the same batch, timed just before (two processes sharing
     one card: the cost of the split, not a scaling figure). Last, two
     sidecars (`python -m hotstuff_tpu_torch.crypto.remote --multihost
     --committee`, warmed up, on adjacent ports, one a rank) are each sent
     the same two 976-item requests in lock step, a genuine one and one
     with forged lanes; both must answer the same bytes, the expected
     masks. A worker or sidecar that fails, or outlives MULTIHOST_TIMEOUT_S,
     fails the phase; every process it started is killed;
  6. the crypto sidecar under full-width load: `remote.start` with the
     reference's defaults (max_batch 8,192, urgent_below 256) on an event
     loop in a thread of this process, around a fresh
     `TorchBackend(device="cuda")` (chunk 4,096, max_bucket 8,192,
     crossover 1), warmed up, phase 5's committee registered. Four
     load-generator processes, one connection each as the nodes of a 4-node
     committee, send back-to-back 976-item requests (one 500,000 B
     payload of 512 B transactions) in three timed passes of 32,768
     distinct triples signed through OpenSSL, ~1/16 corrupted; a fifth
     sends phase 5's 96 QCs of 43 votes on the urgent lane meanwhile.
     Every mask must equal the expected one, no lane may go to a client's
     CPU or the host, the card must verify exactly the lanes sent, with no
     committee batch and no K5 or K2g launch, and every urgent request
     must be a critical dispatch. A fourth pass of distinct triples runs
     under `torch.profiler` for the card's busy share, and a replay of it
     must then be answered by the dedup cache on its valid lanes and by
     the card on its invalid ones. Prints the rate of each pass with where
     its host time went (the loop thread's and the process's CPU, the
     parse, dedup scan, verdict caching and reply encoding, the backend
     calls, the collector's pauses), each urgent round trip's segments
     (p50 and the slowest), and the service's flush counts beside phase
     3's rate;
  7. four unchanged reference nodes (`python -m hotstuff_tpu.node.main
     run --crypto remote --crypto-crossover 1`) and four clients (250 tx/s
     of 512 B each, the reference's local benchmark) run 20 s against
     phase 6's backend, served by `remote.start` in this process; the
     sidecar CLI (`python -m hotstuff_tpu_torch.crypto.remote --committee`)
     boots on the card beside them and answers one QC. Every node must
     commit, digests must agree per round, no node may log a synthetic
     verification failure or a fallback to its CPU, and the card must
     verify lanes with the generic kernels only. The BLS kernels must have
     launched 0 times in phases 3-7;
  8. BLS12-381 G1 aggregation (`hotstuff_tpu_torch/ops/bls.py`): K6's field
     product alone (`hs_bls_mont_mul`) against Python ints and the plain
     `mont_mul` on every pair of 64 residues (0, 1, p - 1, p, 2p - 1, random
     below 2p); 256 keys from the port's `ExactBlsScheme`; a
     `CommitteeTable` at 4, 16, 64, 128 and 256 validators, each with a
     duplicate key, a key beside its negation and an undecodable key (and,
     above 34, both pairs in one partial's lanes); 1,024 bitmap rows each
     (random quorums of floor(2N/3) + 1, then empty, all, one member and
     the special pairs) through `aggregate_masks`, then `verify_aggregate`
     at 64 and 256 validators with a signature under the summed secret
     (right message, wrong message, the invalid lane, the empty bitmap),
     with the launch counts read around them: K6's affine entry
     (`hs_g1_aggregate_affine`) once per aggregation, nothing else. Every
     sum must equal the exact `add_affine` fold (in a spawn pool), every
     verdict the expected one, and both K6 entries (the fold alone,
     `hs_g1_aggregate`, and the affine one) their plain versions limb for
     limb and flag for flag at every size with B = 1,024 and B = 1; then
     each entry's ms at 256 validators (B = 1,024 and 1), the plain
     versions', the bounds and shares, `aggregate_masks`' wall split into
     the mask upload and the affine K6, the readback and `affine_of_limbs`,
     the table builds and `verify_aggregate`'s split into aggregation and
     pairing. Fails on any difference, never on speed.
  9. the f32-argument path (`packed=False`): K7 `bit_ladder` against its
     plain version on the same CUDA tensors (random bits, K3's table of
     random keys) at widths 7, 1,001 (tail quads), 4,096 and 8,192
     (max_bucket, the width of the f32 path's pieces), exactly (raw limbs,
     tolerance 0),
     timed at 128, 4,096 and 8,192 lanes with its ptxas line (registers,
     stack, spills), its bound from this run's bits and its share; then
     phase 3's 16,384-lane batch through
     `Ed25519TorchVerifier(device="cuda", kernel=k, packed=False)` for k in
     bits, w4 and pallas (max_bucket 8,192: two pieces): each mask must
     equal phase 3's expected mask, each counted run must launch exactly
     K3, K7 (bits) or K1 (w4, pallas) and K4 once per piece, and a traced
     batch of each must put nothing on the default stream (a trace that
     holds fewer of those launches than the run made is retried, and its
     busy share is dropped if none holds them all); each leg's
     sigs/s is printed beside phase 3's packed rate. Signatures with s +
     2^253 must give the raw masks the reference's give (bits True, w4
     False). Last, `sharded_verify` on the 1-GPU mesh and on virtual meshes
     of 2 and 4 shards on `cuda:0` (bits and w4, one 8,192-lane piece) must
     give the single-device mask with `n_valid` its sum before s < L, and
     `ShardedEd25519TorchVerifier(packed=False, kernel="bits")` on each
     mesh the expected mask, with K3, K7 and K4 launched pieces x shards
     times each (the K7 row's `mesh_launches`). Phases 2-8 must launch K7
     0 times.
 10. device tuning: kernel K8 (`hotstuff_tpu_torch/ops/field12.py`, the
     radix-2^12 field; `hs_field12` for sqr_n, `hs_field12_mul`,
     `hs_field12_sub`, `hs_field12_canonical`; its layout printed: threads
     a lane, rows and products of each) against its plain version on the
     same CUDA tensors at every width of WIDTHS and at 4,096 lanes,
     exactly (uint32 limbs, tolerance 0): mul on normalized operands and on
     one lazy add, sub on lazy-add inputs, canonical on 264-bit encodings
     (p, p + 1, 2p - 1, 2p, 2^264 - 1, 500p + 7, random) and on products,
     sqr_n with n = 1 and 64; canonical also against v mod p. The tool's
     kernels likewise: `hs_field_sqr_n` (64 squarings on the production
     field) against `field.sqr_n`, `hs_alu_chain` (all three chains, 3 and
     64 steps) against its plain chains. Then each one's device ms, its
     plain version's, the bound and the share, K8's sqr_n(., 64) at 128
     and 4,096 lanes, and ptxas. Last, `python3 -m
     hotstuff_tpu_torch.tune_device --all` as a user runs it, in its own
     process with a time limit: it must exit 0, print every leg's rows and
     launch its kernels (its last line counts them; these are the K8 rows'
     `launches`). Phases 2-9 must launch K8 and the tool's kernels 0 times,
     and phases 9-10 the BLS kernels 0 times.
 11. the port's bench: `hotstuff_tpu_torch.bench.main(argv)` in this
     process, at full width (batch 16,384, chunk 4,096, `--iters 8
     --e2e-iters 3`), six runs: `--committee-cache on`, `--committee-cache
     off`, `--kernel bits --device-batch 8192`, `--mesh` (every visible
     GPU), `--pipeline-ab` and `--committee-scale --e2e-iters 1
     --cpu-budget 0.5`, each with `--metrics-out` to a file of its own under
     `.chip_smoke/`. Each run's output is echoed; each must end with a JSON
     line that parses and equals what `main` returned, with backend "cuda"
     and a positive value, launch exactly the kernels of its legs
     (`bench_kernels`: no K6, K8 or the tool's kernels) and leave a metrics
     dump that holds `TorchBackend`'s routing counters; the
     committee-scale table's QCs must each have been routed once, each
     committee's on one route. The `--committee-cache on` run also serves
     `--telemetry-port 0`: its endpoint is scraped once with the port's
     `telemetry.scrape_sync` (a telemetry dump labelled `bench` with the
     reference's SLO set and the device timeline) and then closed. Prints
     each run's time and the phase's.
 12. the bench's AggQC, scheduler and client-plane legs, through
     `bench.main(argv)` in this process as phase 11's runs (metrics, the
     flight recorder, the timeline and the launch counts reset before
     each), each with `--metrics-out` and `--trace-out` to files under
     `.chip_smoke/` (every trace dump must load): `--aggregate-ab
     --agg-sizes 4,16,64,256` must verify every certificate, give 204-byte
     AggQCs (spread 1.0) and the reference's entry-list bytes (428, 1,580,
     6,188 at 4, 16, 64; 44 + 96 n), and launch K6's affine entry once a
     `verify_aggregate` and nothing else; `--scheduler-ab` at the
     reference's defaults (bulk 512 x 3 feeders, critical 44 every 20 ms,
     6 s a leg) must verify in both legs with every mask all True, flush
     through `_run_legacy` and `DeviceScheduler.run`, and launch only K2,
     K3, K1 and K4 (each lane's p50/p99, `p99_improvement` and
     `verified_ratio` printed); `--ingress` at the reference's defaults
     (100 tx/s, flash x5 in the middle third, 10 s, 8 clients, batch 64)
     and at `--ingress-rate 5000` must reject no signature and commit what
     the pipeline accepted (offered against the curve, committed, shed,
     latency, the signer and its rate, and the card / host route split
     printed, never gated). Last, the forced ingress check: 256
     transactions of the port's load generator, 1/16 with a flipped
     signature bit, submitted to an `IngressPipeline` over
     `TorchBackend(device="cuda")` before its drain first runs: every
     status must be the expected one, and K2, K3, K1 and K4 must each
     launch 4 times (four 64-transaction batches), nothing else.
 13. the port's own committee on the card: four `python -m
     hotstuff_tpu_torch.node.main -vv run --crypto torch
     --crypto-crossover 1 --metrics-out ...` processes, each with its own
     `TorchBackend` on cuda:0 and the committee registered (keys from the
     port's `node.main keys`, phase 7's committee layout and
     `LOCAL_NODE_PARAMS`, `benchmark_mode` on), and four `python -m
     hotstuff_tpu_torch.node.client` processes at `LOCAL_BENCH` (1,000
     tx/s in all, 512 B, 20 s). Every node must commit, with equal digests
     wherever two commit a round (`check_commits`); no node may log a
     synthetic verification failure; each node's dump (written at its
     SIGTERM) must show lanes on the card on both the generic and the
     committee route, none on the host, K2, K3, K1, K4, K2g and K5
     launched at least once and every other kernel (K6, K7, K8, the tool's)
     0 times. Prints the boot time, committed blocks a second within the
     client traffic (`committed_between`), committed transactions a
     second (`committed_txs`), rounds, the lanes of each route, each
     node's launches (the rows' `node_launches`) and where its time went
     (`node_dump_timings`: commit latency, proposal to vote, the
     consensus and mempool lanes' queueing, the card's dispatch and
     readback, p50 and p99; its batches and their mean size). Each node
     also serves its telemetry plane (`--telemetry-port`), scraped twice
     during the traffic (SCRAPE_AT_S) with the port's `scrape_sync`: each
     scrape must be the node's telemetry dump, the snapshot ring must grow
     between the two, the consensus and mempool lanes must have events and
     the ring must hold verifier batches (the verify.e2e SLO's events); the
     node's dump must hold one `verifier.e2e_s` sample per verifier batch,
     but for those in flight at SIGTERM (at most NODE_IN_FLIGHT).
     Prints each node's snapshots, lanes, active and fired alerts and
     `verifier.e2e_s` p50 / p99. Each node also runs with `--trace-out`,
     so its batch service feeds the anomaly watchdog a sample of each
     card flush's per-signature cost: each node must write its flight
     recorder's dump at SIGTERM and log the verify baseline its watchdog
     took (`node_watchdog`); the phase prints each node's baseline (us a
     signature), its `verify_regression` triggers and its auto-dump files,
     and its committed tx/s and blocks a second with every node traced. A
     trigger on this healthy run is reported, not failed. `--tracing-ab`
     builds the kernels and runs this phase alone, six times in turns:
     with `HOTSTUFF_TRACE=0`, with tracing on but no dump, and with
     `--trace-out` (`tracing_ab`), so that what the tracing costs shows
     beside the swing between runs;
 14. the port's tools and stealing: `python -m hotstuff_tpu_torch.latch_probe`
     (its `main`, in this process) on the card must report
     `contracts_held` (organic masks right with K2 launched and no
     fallback, a forced K2 failure propagating, a transient one too, the
     latch on); `python -m hotstuff_tpu_torch.roofline --rate <phase 3's
     sigs/s> --committee <phase 5's table>` must print, for each kernel of
     both paths, the bound of its row in the kernels line; and a
     `BatchVerificationService` with a home and one steal `TorchBackend`,
     both on cuda:0, takes a 4,096-lane bulk flood: `pipeline.steals`
     must move, every mask must be the expected one, and the backends'
     card lanes must add up to the lanes sent (one card: the accounting
     only); last, the forced watchdog check (`phase_watchdog`): a traced
     `BatchVerificationService` over a `TorchBackend` on the card takes
     WATCHDOG_CARD_FLUSHES (32) flushes of WATCHDOG_LANES (1,024) real
     signatures (1/16 corrupted) on the card, then WATCHDOG_HOST_FLUSHES (8)
     of the same size on OpenSSL (its crossover raised above the flush
     size): the watchdog, reset before, must fire `verify_regression`
     exactly once, on the last of the OpenSSL flushes, every mask must
     equal OpenSSL's, and K2, K3, K1 and K4 must launch once a card flush
     and nothing on the OpenSSL stretch. Prints both per-signature costs
     and the launches;
 15. the port's client ingress and commit proofs: four port nodes as in
     phase 13 (`--crypto torch --crypto-crossover 1`, keys written in
     process), their parameters with `ingress_enabled`
     (INGRESS_NODE_PARAMS), front ports whose ingress (+1,000) and proof
     (+2,000) ports are free too; then two legs of `python -m
     hotstuff_tpu_torch.loadgen` against node 0's ingress port, each in
     processes of its own (INGRESS_LEGS: a flash curve, 5x the rate in
     the middle third, 10 s, 8 clients, 512 B; leg A 100 tx/s with
     `--proofs`, leg B 5,000 tx/s over `--procs 4`), INGRESS_SETTLE_S
     after each. Every run must exit 0 with nothing unresolved and no
     transport error, offered = accepted + shed + rejected, no valid
     signature rejected (`ingress.rejected_sigs` 0 on every node), and in
     leg A every accepted transaction's proof served and bound; no node
     may count `proofs.cert_mismatch`; every node commits with equal
     digests; each node's dump passes phase 13's lanes and launches
     check, and node 0's shows verified client signatures and K2, K3, K1
     and K4 launched. Each distinct certificate of leg A
     (`--proofs-out`) is then checked fully by `CommitProof.verify`
     under a `TorchBackend` on the card and under OpenSSL: the verdicts
     must be equal and all pass, and a copy with a flipped payload digest
     and one with a flipped vote signature bit must fail on both. Prints
     each leg's counts, committed tx/s (the commits stamped from the
     curve's start to the end of the settle, over that window), client and proof
     latency p50 / p99, `proof_bytes_max` and how long after the curve's
     end its last answer came (`answer_tail_s`, against the generator's
     LOADGEN_GRACE_S), and each node's lanes, launches and
     `ingress.*` / `proofs.*` counters (the rows' `ingress_node_launches`);
 16. the port's in-process testbed: `python -m hotstuff_tpu_torch.node.main
     deploy --nodes 4 --crypto-crossover 1 --metrics-out ...` in a run
     directory of its own, after a check that 7000-7003, 7100-7103 and
     7200-7203 are free (a taken port fails the phase and is named; the
     ports never move): four nodes in one process on one `TorchBackend` on
     the card, no committee registered. Four `node.client` processes send
     LOCAL_BENCH's 1,000 tx/s of 512 B in all to the front ports for
     DEPLOY_TRAFFIC_S (15 s), then SIGTERM. Every round in the log must
     carry one digest, committed by all four nodes up to the newest round
     that all four committed (`deploy_commit_errors`); the dump must show
     lanes on the card, none on the host or the committee route, K2, K3,
     K1 and K4 launched and nothing else (the rows' `deploy_launches`),
     and every width the largest batch can reach (`deploy_widths`) must be
     among phase 2's. Prints committed rounds, commit lines and blocks a
     second a node within the traffic (`committed_between`), committed
     transactions a second, lanes, launches and where the time went.
Before the kernels line, `phase seconds:` gives the wall seconds of each
stretch of the run (`Laps`), so that two runs compare phase by phase.
Not run here, because they reach no kernel by design (ROADMAP §C,
departure 9): the scenario matrix (`python -m hotstuff_tpu_torch.chaos_run
--matrix`), `python -m hotstuff_tpu_torch.loadgen --selftest` and the
bench's `--ingress-backend pure` / `--sched-backend pure` legs, which all
verify on the port's pure-Python verifier on the host.
The last line is `{"ok": true, "device": {...}}`. Imports nothing of JAX
or of `hotstuff_tpu` (phase 7 runs the reference's node as processes;
phases 13, 15 and 16 the port's). The bound column's model and constants come from
`hotstuff_tpu_torch/roofline.py`.
Exits non-zero without a result when no CUDA device is available or the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import base64
import calendar
import gc
import hashlib
import json
import multiprocessing
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
LANES = 4096
BATCH = 16384
CHUNK = 4096
MAX_BUCKET = 8192

# The bound column's model and constants have one source, the port's
# roofline module (`python -m hotstuff_tpu_torch.roofline`); main() reports
# a missing package before anything reads them.
try:
    from hotstuff_tpu_torch.roofline import (  # noqa: F401
        BIT_DBL_PRODUCTS, BIT_MADD_PRODUCTS, BLS_CHAIN_PRODUCTS, BLS_CHAIN_SQUARES, BLS_OPS_PER_AFFINE,
        BLS_OPS_PER_CHAIN, BLS_OPS_PER_MEMBER, BLS_OPS_PER_PRODUCT, BLS_OPS_PER_REDUCTION, BLS_OPS_PER_SQUARE,
        H_DIGITS_OPS_PER_LANE, HBM_BYTES_PER_S, INT32_OPS_PER_S, REDUCE_OPS_PER_LANE, kernel_bytes)
    from hotstuff_tpu_torch.roofline import bound_ms as _bound_ms
except ImportError:
    pass

RFC8032_VECTORS = [  # (public key, message, signature), RFC 8032 section 7.1
    ("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# --- corpus workers (spawned processes: picklable top-level functions) ------


def _sign_one(args: tuple[bytes, bytes]) -> tuple[bytes, bytes]:
    from hotstuff_tpu_torch.crypto import pysigner

    seed, msg = args
    pk, _ = pysigner.keypair_from_seed(seed)
    return pk, pysigner.sign(seed, msg, public_key=pk)


def _sign_vote(args: tuple[bytes, bytes, bytes]) -> bytes:
    from hotstuff_tpu_torch.crypto import pysigner

    seed, msg, pk = args
    return pysigner.sign(seed, msg, public_key=pk)


def _keypair(seed: bytes) -> bytes:
    from hotstuff_tpu_torch.crypto import pysigner

    return pysigner.keypair_from_seed(seed)[0]


def _verify_one(args: tuple[bytes, bytes, bytes]) -> bool:
    from hotstuff_tpu_torch.crypto import pysigner

    return pysigner.verify_device_semantics(*args)


# --- phase 1 -----------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def phase_build() -> float:
    from hotstuff_tpu_torch.ops import _build

    secs = _build.build_all()
    print(f"build: {secs:.1f} s ({_build.build_dir()})", flush=True)
    report = _build.ptxas_report()
    for name, line in report.items():
        print(f"ptxas {name}: {line}", flush=True)
    for name in NO_SPILL:
        if _build.spill_bytes(report[name]):
            fail(f"ptxas reports spills for {name}: {report[name]}")
    for name in NO_STACK:
        if _build.stack_bytes(report[name]):
            fail(f"ptxas reports a stack frame for {name}: {report[name]}")
    return secs


# --- phase 2: kernels against their plain versions ---------------------------

# Widths the verifier ships to the ladders: one vote, a few, a quorum of 43,
# `min_bucket`, a ragged width, a full chunk. Cut to LANES.
WIDTHS = (1, 7, 43, 128, 1000, 4096)
# A node's bulk buckets above `min_bucket` (doubling up to the chunk): the
# widths at which phases 13 and 15's nodes launch the generic kernels, whose
# scheduler closes bulk buckets at multiples of 128 lanes. Their committee
# kernels take certificates of a few votes, one bucket of 128.
NODE_BUCKETS = (256, 512, 1024, 2048)


def _widths(extra=()) -> list[int]:
    return sorted({w for w in WIDTHS + tuple(extra) if w < LANES}) + [LANES]


def _cut(t, w: int):
    """The first w lanes (the last axis) of t, contiguous."""
    return t[..., :w].contiguous()


def _plain_ms(fn) -> tuple[float, object]:
    """One timed call of a plain version (its first call is the one that
    the comparison uses), CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _max_abs(a, b) -> int:
    return (a.long() - b.long()).abs().max().item()


def _special_keys():
    """Key encodings the decompression must get right: y >= p, x = 0 with
    the sign bit set, y = 0 and y = 1, the all-ones encoding."""
    p = 2**255 - 19
    encs = [p, p + 1, p + 18, 1 | (1 << 255), 1, 0, (p - 1) | (1 << 255), 2**256 - 1]
    return [e.to_bytes(32, "little") for e in encs]


K4_IDENTITY_R = {1: 1, 3: 2**255 - 19 + 1, 9: 1 | 1 << 255}  # lane -> R of an identity lane


def _k4_inputs(rng, point, enc, dev):
    """K4's inputs from K1's points and their encodings `enc`: (xyzt, R
    rows, valid, the mask known by construction as a list). Lanes 3i are
    scaled by a random lambda with the plain `field.mul`; the lanes of
    K4_IDENTITY_R hold the identity (0, 1, 1, 0), and only R = 1 matches it
    (p + 1 is not canonical, 1 | 2^255 sets the sign bit of x = 0); even
    lanes carry their point's encoding, odd lanes random bytes; every
    seventh lane (5, 12, ...) is not valid."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops import field

    n = point.shape[-1]
    lam = field.limbs_of_int([int.from_bytes(rng.bytes(32), "little") % (field.P - 1) + 1 for _ in range(0, n, 3)]).to(dev)
    xyzt = point.clone()
    for c in range(4):
        xyzt[c, :, ::3] = field.mul(point[c, :, ::3].long(), lam).to(torch.int32)
    r = torch.from_numpy(rng.integers(0, 256, (32, n), np.uint8)).to(dev)
    r[:, ::2] = enc[:, ::2]
    valid = [i % 7 != 5 for i in range(n)]
    want = [v and i % 2 == 0 for i, v in enumerate(valid)]
    for lane, r_int in K4_IDENTITY_R.items():
        if lane < n:
            xyzt[:, :, lane] = torch.tensor([[0] * field.NL, [1] + [0] * 9, [1] + [0] * 9, [0] * field.NL],
                                            dtype=torch.int32, device=dev)
            r[:, lane] = torch.tensor(list(r_int.to_bytes(32, "little")), dtype=torch.uint8, device=dev)
            want[lane] = valid[lane] and r_int == 1
    return xyzt, r, torch.tensor(valid, device=dev), want


def phase_compare(seed: int, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from hotstuff_tpu_torch.breakdown import queued_ms
    from hotstuff_tpu_torch.ops import field, ladder, sha512
    from hotstuff_tpu_torch.ops import ed25519 as ed

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    rows = lambda n: torch.from_numpy(rng.integers(0, 256, (n, LANES), np.uint8)).to(dev)
    results = {}

    # K2: h digits on random R / A / M rows; a sample against hashlib.
    r, a, m = rows(32), rows(32), rows(32)
    hd_full = sha512.h_digits(r, a, m)
    plain_ms, want = _plain_ms(lambda: sha512.h_digits_plain(r, a, m))
    if not torch.equal(hd_full, want):
        fail("K2 h_digits differs from its plain version")
    rh, ah, mh = (t.T.cpu().numpy() for t in (r, a, m))
    for i in range(0, LANES, 257):
        hv = int.from_bytes(hashlib.sha512(rh[i].tobytes() + ah[i].tobytes() + mh[i].tobytes()).digest(), "little") % ed.L_ORDER
        digits = [(hv >> (4 * d)) & 15 for d in range(64)]
        if hd_full[:, i].tolist() != digits:
            fail(f"K2 h_digits lane {i} differs from hashlib")
    for w in _widths(NODE_BUCKETS)[:-1]:
        args = (_cut(r, w), _cut(a, w), _cut(m, w))
        if not torch.equal(sha512.h_digits(*args), sha512.h_digits_plain(*args)):
            fail(f"K2 h_digits differs from its plain version at width {w}")
    # Rows at an address that is not 16-byte aligned take the byte-wide path.
    flat = torch.empty(3 * 32 * LANES + 1, dtype=torch.uint8, device=dev)[1:].view(3, 32, LANES)
    flat.copy_(torch.stack((r, a, m)))
    if not torch.equal(sha512.h_digits(flat[0], flat[1], flat[2]), hd_full):
        fail("K2 h_digits differs on rows at a misaligned address")
    w_small = min(128, LANES)
    small = (_cut(r, w_small), _cut(a, w_small), _cut(m, w_small))
    ms, ms_small = queued_ms(lambda: sha512.h_digits(r, a, m), 20), queued_ms(lambda: sha512.h_digits(*small), 20)
    print(f"K2: digits identical to the plain version at widths {_widths(NODE_BUCKETS)} and at a misaligned address; "
          f"{ms_small:.4f} ms at {w_small} lanes, {ms:.4f} ms at {LANES}", flush=True)
    results["h_digits"] = dict(
        ms=ms, plain_ms=plain_ms,
        max_abs_err=_max_abs(hd_full, want),
        bytes=kernel_bytes("h_digits", LANES), ops=LANES * H_DIGITS_OPS_PER_LANE,
    )

    # K3: random keys (about half decompress) and the special encodings; the
    # table's raw limbs and valid exactly, at every width of WIDTHS.
    keys = rows(32)
    special = _special_keys()
    for i, enc in enumerate(special):
        keys[:, i] = torch.tensor(list(enc), dtype=torch.uint8, device=dev)
    table, valid = ed.decompress_table(keys)
    field.PRODUCTS.n = 0
    plain_ms, (ptable, pvalid) = _plain_ms(lambda: ed.decompress_table_plain(keys))
    products = field.PRODUCTS.n
    if not torch.equal(valid, pvalid):
        fail("K3 validity mask differs from its plain version")
    err = _max_abs(table, ptable)
    if err != 0:
        fail(f"K3 table differs from its plain version in raw limbs (max |diff| {err})")
    for w in _widths(NODE_BUCKETS)[:-1]:
        got, want = ed.decompress_table(_cut(keys, w)), ed.decompress_table_plain(_cut(keys, w))
        if not all(torch.equal(g, p) for g, p in zip(got, want)):
            fail(f"K3 decompress_table differs from its plain version at width {w}")
    small = _cut(keys, w_small)
    ms, ms_small = queued_ms(lambda: ed.decompress_table(keys), 20), queued_ms(lambda: ed.decompress_table(small), 20)
    print(f"K3: {int(valid.sum())}/{LANES} random+special keys decompress; raw limbs and valid identical "
          f"to the plain version at widths {_widths(NODE_BUCKETS)}; {ms_small:.4f} ms at {w_small} lanes, {ms:.4f} ms at {LANES}",
          flush=True)
    results["decompress_table"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bytes=kernel_bytes("decompress_table", LANES), ops=LANES * products,
    )

    # K1: random digits with K3's tables, raw limbs against the plain
    # version at every width of WIDTHS.
    sd = torch.from_numpy(rng.integers(0, 16, (64, LANES), np.uint8)).to(dev)
    hd = torch.from_numpy(rng.integers(0, 16, (64, LANES), np.uint8)).to(dev)
    point = ladder.ladder(sd, hd, table)
    field.PRODUCTS.n = 0
    plain_ms, ppoint = _plain_ms(lambda: ladder.ladder_plain(sd, hd, table))
    products = field.PRODUCTS.n
    err = _max_abs(point, ppoint)
    if err != 0:
        fail(f"K1 ladder differs from its plain version (max |diff| {err})")
    for w in _widths(NODE_BUCKETS)[:-1]:
        args = (_cut(sd, w), _cut(hd, w), _cut(table, w))
        if not torch.equal(ladder.ladder(*args), ladder.ladder_plain(*args)):
            fail(f"K1 ladder differs from its plain version at width {w}")
    enc_p = ed.compress(ppoint)
    small = (_cut(sd, w_small), _cut(hd, w_small), _cut(table, w_small))
    ms, ms_small = queued_ms(lambda: ladder.ladder(sd, hd, table), 5), queued_ms(lambda: ladder.ladder(*small), 20)
    print(f"K1: raw limbs identical to the plain version at widths {_widths(NODE_BUCKETS)}; "
          f"{ms_small:.4f} ms at {w_small} lanes, {ms:.4f} ms at {LANES}", flush=True)
    results["ladder"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bytes=kernel_bytes("ladder", LANES), ops=LANES * products,
    )

    # K4: the mask must equal the plain version's at every width of WIDTHS,
    # and the mask known by construction (_k4_inputs).
    xyzt, r_bytes, k4_valid, k4_want = _k4_inputs(rng, point, enc_p, dev)
    got = ed.compress_eq(xyzt, r_bytes, k4_valid)
    field.PRODUCTS.n = 0
    plain_ms, want = _plain_ms(lambda: ed.compress_eq_plain(xyzt, r_bytes, k4_valid))
    products = field.PRODUCTS.n
    if not torch.equal(got, want):
        fail("K4 compress_eq differs from its plain version")
    if got.cpu().tolist() != k4_want:
        fail("K4 compress_eq differs from the mask known by construction")
    for w in _widths(NODE_BUCKETS)[:-1]:
        args = (_cut(xyzt, w), _cut(r_bytes, w), _cut(k4_valid, w))
        if not torch.equal(ed.compress_eq(*args), ed.compress_eq_plain(*args)):
            fail(f"K4 compress_eq differs from its plain version at width {w}")
    small = (_cut(xyzt, w_small), _cut(r_bytes, w_small), _cut(k4_valid, w_small))
    ms = queued_ms(lambda: ed.compress_eq(xyzt, r_bytes, k4_valid), 20)
    ms_small = queued_ms(lambda: ed.compress_eq(*small), 20)
    print(f"K4: mask identical to the plain version at widths {_widths(NODE_BUCKETS)} "
          f"({int(got.sum())}/{LANES} lanes match); {ms_small:.4f} ms at {w_small} lanes, {ms:.4f} ms at {LANES}",
          flush=True)
    results["compress_eq"] = dict(
        ms=ms, plain_ms=plain_ms,
        max_abs_err=_max_abs(got, want), bytes=kernel_bytes("compress_eq", LANES), ops=LANES * products,
    )
    # A ragged width (not a multiple of any block size) through every kernel:
    # each lane is independent, so it must equal the full run's first lanes.
    w = 1000
    cut = lambda t: t[..., :w].contiguous()
    if not torch.equal(sha512.h_digits(cut(r), cut(a), cut(m)), cut(hd_full)):
        fail("K2 differs at a ragged width")
    rt, rv = ed.decompress_table(cut(keys))
    if not (torch.equal(rt, cut(table)) and torch.equal(rv, cut(valid))):
        fail("K3 differs at a ragged width")
    if not torch.equal(ladder.ladder(cut(sd), cut(hd), rt), cut(point)):
        fail("K1 differs at a ragged width")
    if not torch.equal(ed.compress_eq(cut(xyzt), cut(r_bytes), cut(k4_valid)), cut(got)):
        fail("K4 differs at a ragged width")
    for name, res in results.items():
        res["bound_ms"], res["bound_by"] = _bound_ms(res["bytes"], res["ops"])
        print(f"{name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.1f} ms, "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) per {LANES}-lane call", flush=True)
    return results


def _reduce_values() -> list[list[int]]:
    """The values of tests/test_torch_sha512.py's reduction tests: the edge
    list of test_reduce_mod_l_exact and the 4,096-value sweep of
    test_reduce_mod_l_random_sweep (all-ones rows with one zero byte,
    multiples of L plus -3..2), built the same way from the same seed."""
    import numpy as np

    L = 2**252 + 27742317777372353535851937790883648493
    edges = [0, 1, L - 1, L, L + 1, 2 * L - 1, 2**252, 2**256 - 1, 2**512 - 1,
             (L << 134) + 5, (L << 259) - 1]
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (4096, 64), np.uint8)
    raw[:256] = 0xFF
    raw[:256, rng.integers(0, 64, 256)] = 0
    sweep = [int.from_bytes(row.tobytes(), "little") for row in raw]
    for i in range(256, 512):
        k = int(rng.integers(1, 2**62)) << int(rng.integers(0, 190))
        sweep[i] = min(k * L + int(rng.integers(-3, 3)), 2**512 - 1) % 2**512
    return [edges, sweep]


def phase_reduce_compare(device: str = "cuda") -> dict:
    """K2's reduction alone (`hs_reduce_mod_l`): the kernel's own
    `reduce_mod_l` device function against the plain `reduce_mod_l` on the
    same tensors and against Python ints, on the edge values and the
    sweep, exactly."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.breakdown import queued_ms
    from hotstuff_tpu_torch.ops import sha512

    dev = torch.device(device)
    err, values = 0, _reduce_values()
    for vals in values:  # the edges, then the sweep, which is timed
        x = torch.from_numpy(np.array([list(v.to_bytes(64, "little")) for v in vals], np.uint8).T.copy()).to(dev)
        got = sha512.reduce_mod_l_device(x)
        plain_ms, want = _plain_ms(lambda: sha512.reduce_mod_l(x))
        if not torch.equal(got, want):
            fail(f"hs_reduce_mod_l differs from reduce_mod_l on {len(vals)} values")
        host = got.cpu().numpy()
        if [int.from_bytes(host[:, i].tobytes(), "little") for i in range(len(vals))] != [v % sha512.L for v in vals]:
            fail(f"hs_reduce_mod_l differs from Python ints on {len(vals)} values")
        err = max(err, _max_abs(got, want))
    n = len(values[1])
    res = dict(ms=queued_ms(lambda: sha512.reduce_mod_l_device(x), 20), plain_ms=plain_ms, max_abs_err=err,
               bytes=kernel_bytes("reduce_mod_l", n), ops=n * REDUCE_OPS_PER_LANE)
    res["bound_ms"], res["bound_by"] = _bound_ms(res["bytes"], res["ops"])
    print(f"reduce_mod_l: kernel equals reduce_mod_l and Python ints on {len(values[0])} edge values and the "
          f"{n}-value sweep; {res['ms']:.4f} ms per {n}-value call", flush=True)
    return {"reduce_mod_l": res}


# --- phase 3: the main path --------------------------------------------------


def _corpus(seed: int, pool):
    """4,096 distinct (message, key, signature) over 32-byte digests."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    seeds = [bytes(row) for row in rng.integers(0, 256, (LANES, 32), np.uint8)]
    msgs = [bytes(row) for row in rng.integers(0, 256, (LANES, 32), np.uint8)]
    signed = pool.map(_sign_one, list(zip(seeds, msgs)), chunksize=64)
    return msgs, [k for k, _ in signed], [s for _, s in signed]


def _bad_key() -> bytes:
    """An encoding whose y has no x on the curve (no square root)."""
    from hotstuff_tpu_torch.crypto import pysigner

    y = 2
    while pysigner._recover_x(y, 0) is not None:
        y += 1
    return y.to_bytes(32, "little")


def _corrupt(seed: int, msgs, keys, sigs):
    """Tile to BATCH lanes and corrupt a seeded ~1/16 of them, one class
    per lane in turn. Returns (msgs, keys, sigs, expected mask)."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    M = [msgs[i % LANES] for i in range(BATCH)]
    K = [keys[i % LANES] for i in range(BATCH)]
    S = [sigs[i % LANES] for i in range(BATCH)]
    lanes = np.sort(rng.choice(BATCH, BATCH // 16, replace=False))
    expected = _corrupt_lanes(M, K, S, lanes)
    return M, K, S, expected, lanes


def _corrupt_lanes(M, K, S, lanes):
    """Corrupt `lanes` of the lists M, K, S in place, the six classes in
    turn (flipped R byte, flipped S byte, s >= L, wrong message, a key
    without a square root, non-canonical R). Returns the expected mask."""
    import numpy as np

    from hotstuff_tpu_torch.crypto import pysigner

    expected = np.ones(len(M), bool)
    bad_key = _bad_key()
    noncanon_r = (pysigner.P + 1).to_bytes(32, "little")
    for n, i in enumerate(lanes):
        kind = n % 6
        s = S[i]
        if kind == 0:  # flipped R byte
            S[i] = s[:5] + bytes([s[5] ^ 0x40]) + s[6:]
        elif kind == 1:  # flipped S byte
            S[i] = s[:40] + bytes([s[40] ^ 0x01]) + s[41:]
        elif kind == 2:  # s >= L (s + L, same residue)
            sv = int.from_bytes(s[32:], "little") + pysigner.L
            S[i] = s[:32] + sv.to_bytes(32, "little")
        elif kind == 3:  # wrong message
            M[i] = bytes([M[i][0] ^ 0x80]) + M[i][1:]
        elif kind == 4:  # non-decompressable key
            K[i] = bad_key
        else:  # non-canonical R (y = p + 1)
            S[i] = noncanon_r + s[32:]
        expected[i] = False
    return expected


def _host_hash_batch(pool):
    """33-byte messages signed by pysigner, the RFC 8032 vectors, and the
    vectors perturbed. Returns (msgs, keys, sigs, expected mask)."""
    import numpy as np

    rng = np.random.default_rng(7)
    seeds = [bytes(row) for row in rng.integers(0, 256, (60, 32), np.uint8)]
    msgs = [bytes(row) for row in rng.integers(0, 256, (60, 33), np.uint8)]
    signed = pool.map(_sign_one, list(zip(seeds, msgs)))
    M, K, S = list(msgs), [k for k, _ in signed], [s for _, s in signed]
    expected = [True] * len(M)
    for i in range(0, len(M), 5):  # every fifth lane: flipped message byte
        M[i] = M[i][:-1] + bytes([M[i][-1] ^ 1])
        expected[i] = False
    for pk, msg, sig in RFC8032_VECTORS:
        M.append(bytes.fromhex(msg))
        K.append(bytes.fromhex(pk))
        S.append(bytes.fromhex(sig))
        expected.append(True)
        M.append(bytes.fromhex(msg) + b"\x00")
        K.append(bytes.fromhex(pk))
        S.append(bytes.fromhex(sig))
        expected.append(False)
    return M, K, S, np.array(expected)


GENERIC_KERNELS = ("ladder", "h_digits", "decompress_table", "compress_eq")
NO_SPILL = ("ladder", "committee_ladder", "decompress_table", "compress_eq", "h_digits",
            "bit_ladder", "field12", "g1_aggregate")  # ptxas: 0 spill bytes
NO_STACK = ("g1_aggregate", "field12")  # ptxas: 0 bytes stack frame in every function


def phase_main_path(seed: int) -> dict:
    import numpy as np
    import torch

    from hotstuff_tpu_torch.crypto import native_staging
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ops import _build

    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        msgs, keys, sigs = _corpus(seed, pool)
        M, K, S, expected, lanes = _corrupt(seed, msgs, keys, sigs)
        # Cross-check the expected mask with the exact host verifier on every
        # distinct triple: the 4,096 signatures and each corrupted lane.
        check = list(range(LANES)) + [int(i) for i in lanes]
        host = pool.map(_verify_one, [(K[i], M[i], S[i]) for i in check], chunksize=64)
        if [bool(v) for v in host] != [bool(expected[i]) for i in check]:
            fail("expected mask disagrees with the host verifier")
        HM, HK, HS, hexpected = _host_hash_batch(pool)
        hhost = pool.map(_verify_one, list(zip(HK, HM, HS)))
        if list(hhost) != hexpected.tolist():
            fail("host-hash expected mask disagrees with the host verifier")
    print(f"corpus: {LANES} signatures, {len(lanes)} corrupted lanes, host cross-check "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    backend = TorchBackend(device="cuda", crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    pks, sgs = [PublicKey(k) for k in K], [Signature(s) for s in S]
    _build.reset_launches()
    native_staging.reset_calls()
    mask = backend.verify_batch_mask(M, pks, sgs)
    launches, staged = _build.launches(), native_staging.calls()
    print(f"main path launches: {launches}; native staging calls: {staged}", flush=True)
    if np.array(mask).tolist() != expected.tolist():
        bad = np.flatnonzero(np.array(mask) != expected)
        fail(f"main-path mask differs from expected on {len(bad)} lanes, e.g. {bad[:8].tolist()}")
    if any(launches[k] == 0 for k in GENERIC_KERNELS) or launches["committee_ladder"] or launches["h_digits_idx"]:
        fail(f"the main path did not launch exactly its own kernels: {launches}")
    if backend.stats["host_sigs"] != 0:
        fail(f"lanes verified on the host: {backend.stats}")
    if staged != {k: (-(-BATCH // CHUNK) if k == "stage_packed_dh" else 0) for k in staged}:
        fail(f"the main path did not stage each chunk natively: {staged}")

    iters, times = 5, []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        again = backend.verify_batch_mask(M, pks, sgs)
        end.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0, start.elapsed_time(end) / 1e3))
        if again != mask:
            fail("main-path mask changed between iterations")
    wall = [w for w, _ in times]
    print(f"e2e: {BATCH} signatures per batch, {iters} batches: "
          f"{BATCH * iters / sum(wall):.1f} sigs/s (host clock), "
          f"per batch {[round(w * 1e3, 3) for w in wall]} ms", flush=True)

    _build.reset_launches()
    native_staging.reset_calls()
    hmask = backend.verify_batch_mask(HM, [PublicKey(k) for k in HK], [Signature(s) for s in HS])
    hlaunches = _build.launches()
    print(f"host-hash batch launches: {hlaunches}; native staging calls: {native_staging.calls()}", flush=True)
    if hmask != hexpected.tolist():
        fail("host-hash mask differs from expected")
    if native_staging.calls()["stage_packed_hh"] != 1:
        fail(f"the host-hash batch was not staged natively: {native_staging.calls()}")
    if hlaunches["h_digits"] != 0 or any(hlaunches[k] == 0 for k in ("ladder", "decompress_table", "compress_eq")):
        fail(f"host-hash batch launched the wrong kernels: {hlaunches}")
    print(f"main path pipeline: {_pipeline_line(backend._verifier)}", flush=True)
    return dict(launches=launches, sigs_per_s=BATCH * iters / sum(wall), batch_ms=[w * 1e3 for w in wall],
                batch=(M, K, S, expected))


def _pipeline_line(v, depth: int | None = None) -> dict:
    """The verifier's dispatch pipeline: depth, staging (native or numpy),
    chunks and stalls so far, and whether its staging buffers are
    page-locked (one buffer taken from the pool and given back). Fails
    unless the buffers are pinned and the depth is `depth`, by default the pipeline's default
    (`HOTSTUFF_PIPELINE_DEPTH`, else 2)."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops.pipeline import default_depth

    depth = default_depth() if depth is None else depth
    pool = v.pipeline.pool
    buf = pool.take((128, CHUNK), np.uint8)
    pinned = bool(torch.from_numpy(buf).is_pinned())
    pool.give(buf)
    line = dict(depth=v.pipeline.depth, staging=v.staging, pin=pool.pin, pinned=pinned, **v.pipeline.stats)
    if v.pipeline.depth != depth or not pinned:
        fail(f"the verifier's pipeline is not at depth {depth} with pinned buffers: {line}")
    return line


# --- phase 3b: the native staging plane against the numpy staging -----------

STAGE_TURNS = 7  # timed turns of each staging per form
GROUP_ORDER = 2**252 + 27742317777372353535851937790883648493  # L
EDGE_S = (GROUP_ORDER - 1, GROUP_ORDER, 2**256 - 1)
MSG_LENGTHS = 301  # host-hash messages of 0..300 bytes: R || A || M crosses SHA-512's 112-byte padding edge
# form -> (the verifier's path, device hash)
STAGING_PATHS = {"packed_hh": ("generic", False), "packed_dh": ("generic", True),
                 "committee_hh": ("committee", False), "committee_dh": ("committee", True)}


def staging_forms(batch, votes) -> dict:
    """The four staging forms, name -> (native entry, numpy function, its
    arguments, wire rows): phase 3's batch (generic) and phase 5's votes
    (committee; each vote's key as the host-hash form's key row, indices
    into the votes' distinct keys)."""
    from hotstuff_tpu_torch.crypto import native_staging as ns
    from hotstuff_tpu_torch.ops import ed25519 as ed

    M, K, S = batch[:3]
    CM, CK, CS = votes[:3]
    index = {k: i for i, k in enumerate(dict.fromkeys(CK))}
    idx = [index[k] for k in CK]
    return {
        "packed_hh": (ns.stage_packed_hh, ed.prepare_batch_packed, (M, K, S), 128),
        "packed_dh": (ns.stage_packed_dh, ed.prepare_batch_packed_dh, (M, K, S), 128),
        "committee_hh": (ns.stage_committee_hh, ed.prepare_batch_committee, (CM, CK, idx, CS), 96),
        "committee_dh": (ns.stage_committee_dh, ed.prepare_batch_committee_dh, (CM, idx, CS), 96),
    }


def staging_diff(native, plain, args, rows: int, width: int, shards: int, out=None) -> list[str]:
    """One staging form both ways: the native entry into `out` (by default a
    fresh buffer of 0xA5 bytes, so a pad lane left unwritten shows) and the
    numpy function laid out by `fill_shards` into zeros. Returns what
    differs: nothing when the wire rows, s_ok and idx are equal byte for
    byte."""
    import numpy as np

    from hotstuff_tpu_torch.ops.verifier import fill_shards

    if out is None:
        out = np.full((shards, rows, width // shards), 0xA5, np.uint8)
    got, want = native(*args, out, width, shards), plain(*args)
    ref = np.zeros_like(out)
    fill_shards(ref, want["packed"])
    bad = []
    if got["packed"] is not out or not np.array_equal(out, ref):
        bad.append(f"wire bytes differ at (shard, row, lane) {np.argwhere(out != ref)[:4].tolist()}")
    if not np.array_equal(got["s_ok"], want["s_ok"]):
        bad.append(f"s_ok differs on lanes {np.flatnonzero(got['s_ok'] != want['s_ok'])[:8].tolist()}")
    if "idx" in want and not np.array_equal(got["idx"], want["idx"]):
        bad.append("idx differs")
    return bad


def _cut_args(args, n: int) -> tuple:
    return tuple(a[:n] for a in args)


def staging_cases(forms: dict, lanes: int) -> list[tuple]:
    """(label, form, arguments, width, shards, reuse) of the byte-for-byte
    checks: every form on its whole batch at shards 1, 2 and 4; in a reused
    pooled buffer at a width above n (`reuse`: the buffer first holds the
    form's first `lanes` lanes, then a smaller cut); the host-hash forms on
    `lanes` lanes of 0..300-byte messages; every form with s = L - 1, L and
    2^256 - 1 in turn on a third of its first `lanes` lanes."""
    import numpy as np

    rng = np.random.default_rng(11)
    cases = []
    for name, (_, _, args, _) in forms.items():
        n = len(args[0])
        width = -(-n // 512) * 512
        cases += [(f"{name} n={n} shards={sh}", name, args, width, sh, False) for sh in (1, 2, 4)]
        cut = _cut_args(args, lanes - lanes // 3)
        cases += [(f"{name} reused buffer n={len(cut[0])} width={lanes} shards={sh}", name, cut, lanes, sh, True)
                  for sh in (1, 4)]
        first = _cut_args(args, lanes)
        if name.endswith("_hh"):
            msgs = [rng.integers(0, 256, i % MSG_LENGTHS, np.uint8).tobytes() for i in range(len(first[0]))]
            cases += [(f"{name} messages of 0..{MSG_LENGTHS - 1} bytes shards={sh}", name, (msgs, *first[1:]),
                       lanes, sh, False) for sh in (1, 2, 4)]
        sigs = [sig[:32] + EDGE_S[(i // 3) % 3].to_bytes(32, "little") if i % 3 == 0 else sig
                for i, sig in enumerate(first[-1])]
        cases.append((f"{name} s in (L - 1, L, 2^256 - 1)", name, (*first[:-1], sigs), lanes, 2, False))
    return cases


def phase_staging(batch, votes, device: str = "cuda") -> dict:
    """Phase 3b: the native staging plane (`crypto/native_staging.py`)
    against the numpy staging, on the host: every form byte for byte on
    every case of `staging_cases`, then each form's stage ms per CHUNK-lane
    chunk through a native and a numpy verifier's `stage_wire` into their
    pooled buffers (page-locked on the card), STAGE_TURNS turns in turns.
    Fails on any difference; never on speed."""
    import numpy as np

    from hotstuff_tpu_torch.ops.pipeline import StagingBufferPool
    from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier

    forms = staging_forms(batch, votes)
    checked = 0
    for label, name, args, width, shards, reuse in staging_cases(forms, CHUNK):
        native, plain, _, rows = forms[name]
        out = None
        if reuse:  # a pooled buffer that already held a wider chunk
            pool = StagingBufferPool()
            out = pool.take((shards, rows, width // shards), np.uint8)
            if staging_diff(native, plain, _cut_args(forms[name][2], width), rows, width, shards, out):
                fail(f"staging {label}: the first fill differs")
            pool.give(out)
            if pool.take(out.shape, np.uint8) is not out:
                fail(f"staging {label}: the pool did not hand the buffer back")
        bad = staging_diff(native, plain, args, rows, width, shards, out)
        if bad:
            fail(f"staging {label}: native != numpy: {bad}")
        if "s in" in label:
            s_ok = native(*args, np.zeros((shards, rows, width // shards), np.uint8), width, shards)["s_ok"]
            if s_ok[0:9:3].tolist() != [True, False, False]:
                fail(f"staging {label}: s_ok of L - 1, L, 2^256 - 1 is {s_ok[0:9:3].tolist()}")
        checked += 1
    print(f"staging: {checked} cases, native == numpy byte for byte (wire rows, pad lanes, s_ok, idx): the four "
          f"forms at shards 1, 2, 4, reused buffers at a width above n, messages of 0..{MSG_LENGTHS - 1} bytes, "
          f"s = L - 1, L, 2^256 - 1", flush=True)

    legs = {st: Ed25519TorchVerifier(device=device, max_bucket=MAX_BUCKET, chunk=CHUNK, pipeline_depth=1, staging=st)
            for st in ("native", "numpy")}
    times = {name: {st: [] for st in legs} for name in forms}
    try:
        for name, (_, _, args, rows) in forms.items():
            path, device_hash = STAGING_PATHS[name]
            chunk_args = _cut_args(args, CHUNK)
            for _ in range(STAGE_TURNS):
                for st, v in legs.items():
                    out = v.pipeline.pool.take((1, rows, CHUNK), np.uint8)
                    t0 = time.perf_counter()
                    v.stage_wire(path, device_hash, chunk_args, out)
                    times[name][st].append((time.perf_counter() - t0) * 1e3)
                    v.pipeline.pool.give(out)
    finally:
        for v in legs.values():
            v.close()
    res = {name: {st: dict(median_ms=round(statistics.median(t), 4), min_ms=round(min(t), 4), max_ms=round(max(t), 4))
                  for st, t in by.items()} for name, by in times.items()}
    for name, r in res.items():
        r["numpy_over_native"] = round(r["numpy"]["median_ms"] / r["native"]["median_ms"], 3)
    print(f"staging ms per {CHUNK}-lane chunk ({STAGE_TURNS} turns each, native and numpy in turns, into the "
          f"verifier's pooled buffers): {json.dumps(res)}", flush=True)
    return res


# --- phase 4, continued: the dispatch pipeline, depth 1 against depth 2 -------

AB_LANES = 6 * CHUNK  # 24,576 lanes, 6 chunks
AB_ATTEMPTS = 3  # fixed, no early stop (bench.py --pipeline-ab)
AB_ITERS = 3  # batches per attempt and leg


def _top_up(pipeline) -> None:
    """Give the pool `depth` buffers of every shape it has handed out: the
    most a window of `depth` chunks holds at once (a chunk's buffers go back
    before its window slot frees). Whether one warm-up batch reached that
    many depends on timing; after this, any allocation is a buffer that did
    not come back."""
    import numpy as np

    pool = pipeline.pool
    for shape, dtype in list(pool.sizes()):
        bufs = [pool.take(shape, np.dtype(dtype)) for _ in range(pipeline.depth)]
        for b in bufs:
            pool.give(b)


def phase_pipeline_ab(batch, device: str = "cuda") -> dict:
    """bench.py --pipeline-ab on the card: phase 3's batch tiled to AB_LANES
    through `pipeline_depth=1` and `pipeline_depth=2` verifiers, in turns,
    AB_ATTEMPTS attempts of AB_ITERS batches each after one warm-up batch
    per leg (its pool then topped up, `_top_up`). Each attempt reports
    sigs/s (host clock), the device timeline's occupancy, overlap headroom
    and per-chunk phase times, stalls, and the pool's allocations and
    reuses; then one batch per leg under torch.profiler gives the card's
    busy share and the streams of its kernels and copies.
    Fails when a mask differs from the expected one, when a leg allocates a
    staging buffer after its warm-up, or when a launch or copy of the depth
    2 leg lands on the default stream. Never fails on speed."""
    import numpy as np

    from hotstuff_tpu_torch import breakdown
    from hotstuff_tpu_torch.ops import timeline
    from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
    from hotstuff_tpu_torch.utils import metrics

    M, K, S, expected = batch
    lanes = np.arange(AB_LANES) % len(M)
    msgs, keys, sigs = [M[i] for i in lanes], [K[i] for i in lanes], [S[i] for i in lanes]
    want = expected[lanes].tolist()
    allocs, reuse = metrics.counter("pipeline.buffer_allocs"), metrics.counter("pipeline.buffer_reuse")
    legs = {d: Ed25519TorchVerifier(device=device, max_bucket=MAX_BUCKET, chunk=CHUNK, pipeline_depth=d)
            for d in (1, 2)}
    try:
        for d, v in legs.items():
            if v.verify_batch_mask(msgs, keys, sigs).tolist() != want:
                fail(f"pipeline A/B: the depth {d} warm-up mask differs from expected")
            _top_up(v.pipeline)
        _pipeline_line(legs[2], depth=2)
        attempts = {d: [] for d in legs}
        for _ in range(AB_ATTEMPTS):
            for d, v in legs.items():
                a0, r0, st0 = allocs.value, reuse.value, v.pipeline.stats["stalls"]
                timeline.reset()
                t0 = time.perf_counter()
                masks = [v.verify_batch_mask(msgs, keys, sigs) for _ in range(AB_ITERS)]
                wall = time.perf_counter() - t0
                tl = timeline.summary()
                if any(m.tolist() != want for m in masks):
                    fail(f"pipeline A/B: a depth {d} mask differs from expected")
                if allocs.value != a0:
                    fail(f"pipeline A/B: depth {d} allocated {allocs.value - a0} staging buffers after warm-up")
                attempts[d].append(dict(
                    sigs_per_s=AB_LANES * AB_ITERS / wall, batch_ms=wall * 1e3 / AB_ITERS,
                    occupancy=tl["occupancy"], overlap_headroom=tl["overlap_headroom"],
                    idle_ms=tl["idle"]["total_s"] * 1e3 / AB_ITERS, stalls=v.pipeline.stats["stalls"] - st0,
                    phase_ms={p: ms * 1e3 / tl["chunks"] for p, ms in tl["phase_s"].items()},
                    buffer_allocs=allocs.value - a0, buffer_reuse=reuse.value - r0, chunks=tl["chunks"]))
        traced = {}
        for d, v in legs.items():
            out = []
            trace = breakdown.device_trace(lambda: out.append(v.verify_batch_mask(msgs, keys, sigs)),
                                           REPO / ".chip_smoke" / f"trace_depth{d}.json")
            if out[0].tolist() != want:
                fail(f"pipeline A/B: the traced depth {d} mask differs from expected")
            traced[d] = {k: trace[k] for k in ("busy_share", "device_ms", "device_ms_sum", "wall_ms", "kernels",
                                                "streams", "default_stream", "on_default_stream",
                                                "on_default_names")}
        if traced[2]["on_default_stream"]:
            fail(f"pipeline A/B: depth 2 put work on the default stream: {traced[2]}")
    finally:
        for v in legs.values():
            v.close()
    res = {}
    for d in legs:
        rows = attempts[d]
        res[f"depth{d}"] = dict(
            sigs_per_s=[round(r["sigs_per_s"], 1) for r in rows],
            sigs_per_s_median=round(statistics.median(r["sigs_per_s"] for r in rows), 1),
            batch_ms=[round(r["batch_ms"], 3) for r in rows],
            occupancy=[r["occupancy"] for r in rows], overlap_headroom=[r["overlap_headroom"] for r in rows],
            idle_ms=[round(r["idle_ms"], 3) for r in rows], stalls=[r["stalls"] for r in rows],
            phase_ms_per_chunk={p: [round(r["phase_ms"][p], 4) for r in rows] for p in rows[0]["phase_ms"]},
            buffer_allocs=[r["buffer_allocs"] for r in rows], buffer_reuse=[r["buffer_reuse"] for r in rows],
            chunks=rows[0]["chunks"], staging=legs[d].staging, profiler=traced[d])
        print(f"pipeline A/B depth {d}: {json.dumps(res[f'depth{d}'])}", flush=True)
    speedup = res["depth2"]["sigs_per_s_median"] / res["depth1"]["sigs_per_s_median"]
    print(f"pipeline A/B: {AB_LANES} lanes ({AB_LANES // CHUNK} chunks) x {AB_ITERS} batches x "
          f"{AB_ATTEMPTS} attempts in turns, {legs[2].staging} staging; masks equal to expected on both legs; "
          f"depth 2 / depth 1 "
          f"median sigs/s {speedup:.3f}; depth 2 launched nothing on the default stream", flush=True)
    return res


# --- phase 5: the committee path ---------------------------------------------

COMMITTEE = 64  # validators (bench.py --committee-cache)
QUORUM = 2 * COMMITTEE // 3 + 1  # votes per QC: 43
N_QC = BATCH // QUORUM  # 381 QCs, 16,383 votes
SIGNED_QCS = 96  # distinct QCs signed, then tiled to N_QC


def _committee_special_keys() -> list[bytes]:
    """Key encodings where pysigner's strict `verify` and the device decoder
    differ or fail: no square root; y = p + 1 (>= p, reduced to y = 1, the
    identity); y = 1 with the sign bit set (x = 0 takes either sign)."""
    p = 2**255 - 19
    return [_bad_key(), (p + 1).to_bytes(32, "little"), (1 | 1 << 255).to_bytes(32, "little")]


def _forged_identity_sig(s: int) -> bytes:
    """R = enc([s]B), S = s: the device equation, the host verifier and
    OpenSSL accept it for any message under a key that decodes to the
    identity ([h]A vanishes); pysigner's strict `verify` rejects those
    keys."""
    from hotstuff_tpu_torch.crypto import pysigner

    return pysigner._pt_compress(pysigner._pt_mul(s, pysigner._B_POINT)) + s.to_bytes(32, "little")


def phase_committee_compare(seed: int, table_keys: list[bytes], device: str = "cuda") -> dict:
    """K5 and K2g against their plain versions, exactly, at LANES lanes (K5
    also at every width of WIDTHS)."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.breakdown import queued_ms
    from hotstuff_tpu_torch.ops import committee, field, sha512
    from hotstuff_tpu_torch.ops import ed25519 as ed

    dev = torch.device(device)
    rng = np.random.default_rng(seed + 10)
    ct = ed.CommitteeTable(table_keys, dev)
    n = ct.size
    idx_np = rng.integers(0, n, LANES).astype(np.int32)
    oob = [3, LANES // 3, LANES // 2 + 1, LANES - 1]
    idx_np[oob] = [-1, n, 2**31 - 1, -(2**31)]  # out of range
    idx = torch.from_numpy(idx_np).to(dev)
    digits = lambda: torch.from_numpy(rng.integers(0, 16, (64, LANES), np.uint8)).to(dev)
    rows = lambda: torch.from_numpy(rng.integers(0, 256, (32, LANES), np.uint8)).to(dev)
    results = {}

    # K5: random digits and indices, raw limbs and lane_valid exactly, at
    # every width of WIDTHS.
    sd, hd = digits(), digits()
    point, lane_valid = committee.committee_ladder(sd, hd, ct, idx)
    field.PRODUCTS.n = 0
    plain_ms, (ppoint, pvalid) = _plain_ms(lambda: committee.committee_ladder_plain(sd, hd, ct.entries, ct.valid, idx))
    products = field.PRODUCTS.n
    if not torch.equal(lane_valid, pvalid):
        fail("K5 lane_valid differs from its plain version")
    err = _max_abs(point, ppoint)
    if err != 0:
        fail(f"K5 committee_ladder differs from its plain version (max |diff| {err})")
    in_range = (idx_np >= 0) & (idx_np < n)
    want_valid = in_range & ct.valid.cpu().numpy()[np.clip(idx_np, 0, n - 1)]
    if lane_valid.cpu().numpy().tolist() != want_valid.tolist():
        fail("K5 lane_valid is not 0 <= idx < N and valid[idx]")
    for w in _widths()[:-1]:
        args = (_cut(sd, w), _cut(hd, w))
        got, gvalid = committee.committee_ladder(*args, ct, _cut(idx, w))
        want, wvalid = committee.committee_ladder_plain(*args, ct.entries, ct.valid, _cut(idx, w))
        if not (torch.equal(got, want) and torch.equal(gvalid, wvalid)):
            fail(f"K5 committee_ladder differs from its plain version at width {w}")
    w_small = min(128, LANES)
    small = (_cut(sd, w_small), _cut(hd, w_small), ct, _cut(idx, w_small))
    ms = queued_ms(lambda: committee.committee_ladder(sd, hd, ct, idx), 5)
    ms_small = queued_ms(lambda: committee.committee_ladder(*small), 20)
    print(f"K5: raw limbs and lane_valid identical to the plain version at widths {_widths()}; "
          f"{int(lane_valid.sum())}/{LANES} lanes valid; {ms_small:.4f} ms at {w_small} lanes, "
          f"{ms:.4f} ms at {LANES}", flush=True)
    results["committee_ladder"] = dict(
        ms=ms, plain_ms=plain_ms,
        max_abs_err=err,
        bytes=kernel_bytes("committee_ladder", LANES, n), ops=LANES * products,
    )

    # K2g: h digits with A read by index; a sample against hashlib.
    r, m = rows(), rows()
    hk = sha512.h_digits_gather(r, ct.keys_u8, idx, m)
    plain_ms, want = _plain_ms(lambda: sha512.h_digits_gather_plain(r, ct.keys_u8, idx, m))
    if not torch.equal(hk, want):
        fail("K2g h_digits_idx differs from its plain version")
    rh, mh = r.T.cpu().numpy(), m.T.cpu().numpy()
    for i in list(range(0, LANES, 257)) + oob:
        if in_range[i]:
            hv = int.from_bytes(hashlib.sha512(rh[i].tobytes() + table_keys[idx_np[i]] + mh[i].tobytes()).digest(), "little") % ed.L_ORDER
            digits_i = [(hv >> (4 * d)) & 15 for d in range(64)]
        else:
            digits_i = [0] * 64
        if hk[:, i].tolist() != digits_i:
            fail(f"K2g lane {i} differs from hashlib")
    for w in _widths()[:-1]:
        args = (_cut(r, w), ct.keys_u8, _cut(idx, w), _cut(m, w))
        if not torch.equal(sha512.h_digits_gather(*args), sha512.h_digits_gather_plain(*args)):
            fail(f"K2g h_digits_idx differs from its plain version at width {w}")
    small = (_cut(r, w_small), ct.keys_u8, _cut(idx, w_small), _cut(m, w_small))
    ms = queued_ms(lambda: sha512.h_digits_gather(r, ct.keys_u8, idx, m), 20)
    ms_small = queued_ms(lambda: sha512.h_digits_gather(*small), 20)
    print(f"K2g: digits identical to the plain version at widths {_widths()} ({int(in_range.sum())}/{LANES} "
          f"indices in range); {ms_small:.4f} ms at {w_small} lanes, {ms:.4f} ms at {LANES}", flush=True)
    results["h_digits_idx"] = dict(
        ms=ms, plain_ms=plain_ms,
        max_abs_err=_max_abs(hk, want), bytes=kernel_bytes("h_digits_idx", LANES, n),
        ops=LANES * H_DIGITS_OPS_PER_LANE,
    )

    # A ragged width: each lane is independent.
    w = 1000
    cut = lambda t: t[..., :w].contiguous()
    rp, rv = committee.committee_ladder(cut(sd), cut(hd), ct, cut(idx))
    if not (torch.equal(rp, cut(point)) and torch.equal(rv, cut(lane_valid))):
        fail("K5 differs at a ragged width")
    if not torch.equal(sha512.h_digits_gather(cut(r), ct.keys_u8, cut(idx), cut(m)), cut(hk)):
        fail("K2g differs at a ragged width")
    for name, res in results.items():
        res["bound_ms"], res["bound_by"] = _bound_ms(res["bytes"], res["ops"])
        print(f"{name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.1f} ms, "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) per {LANES}-lane call", flush=True)
    return results


def _committee_corpus(seed: int, pool):
    """The committee's keys and a QC-shaped vote batch: N_QC QCs of QUORUM
    votes, each QC over one 32-byte digest (as bench.py:_qc_batch), with
    SIGNED_QCS distinct QCs signed and tiled, then a seeded ~1/16 of lanes
    corrupted. Returns (validator seeds, keys, msgs, vote keys, sigs,
    expected mask, corrupted lanes, identity-forged lanes)."""
    import numpy as np

    from hotstuff_tpu_torch.crypto import pysigner

    rng = np.random.default_rng(seed + 3)
    seeds = [bytes(row) for row in rng.integers(0, 256, (COMMITTEE, 32), np.uint8)]
    pks = pool.map(_keypair, seeds)
    digests = [bytes(row) for row in rng.integers(0, 256, (SIGNED_QCS, 32), np.uint8)]
    voters = [rng.choice(COMMITTEE, QUORUM, replace=False) for _ in range(SIGNED_QCS)]
    jobs = [(seeds[v], digests[q], pks[v]) for q in range(SIGNED_QCS) for v in voters[q]]
    signed = pool.map(_sign_vote, jobs, chunksize=64)
    n = N_QC * QUORUM
    M = [jobs[i % len(jobs)][1] for i in range(n)]
    K = [jobs[i % len(jobs)][2] for i in range(n)]
    S = [signed[i % len(jobs)] for i in range(n)]
    expected = np.ones(n, bool)
    no_sqrt, y_ge_p, x0_sign = _committee_special_keys()
    forged = [_forged_identity_sig(int(rng.integers(1, 2**62))) for _ in range(2)]
    noncanon_r = (pysigner.P + 1).to_bytes(32, "little")
    lanes = np.sort(rng.choice(n, n // 16, replace=False))
    identity_lanes = []
    for c, i in enumerate(lanes):
        kind, s = c % 8, S[i]
        if kind == 0:  # flipped R byte
            S[i] = s[:5] + bytes([s[5] ^ 0x40]) + s[6:]
        elif kind == 1:  # flipped S byte
            S[i] = s[:40] + bytes([s[40] ^ 0x01]) + s[41:]
        elif kind == 2:  # s >= L (s + L, same residue)
            S[i] = s[:32] + (int.from_bytes(s[32:], "little") + pysigner.L).to_bytes(32, "little")
        elif kind == 3:  # wrong message
            M[i] = bytes([M[i][0] ^ 0x80]) + M[i][1:]
        elif kind == 4:  # non-canonical R (y = p + 1)
            S[i] = noncanon_r + s[32:]
        elif kind == 5:  # a vote by the key without a square root
            K[i] = no_sqrt
        else:  # identity keys: y >= p, x = 0 with the sign bit; accepted
            K[i], S[i] = (y_ge_p, forged[0]) if kind == 6 else (x0_sign, forged[1])
            identity_lanes.append(int(i))
            continue
        expected[i] = False
    return seeds, pks, M, K, S, expected, lanes, identity_lanes


def _host_hash_votes(seeds, pks):
    """One QC of votes over a 33-byte message (host-hash committee format),
    every fifth signature's R flipped."""
    from hotstuff_tpu_torch.crypto import pysigner

    msg = hashlib.sha256(b"host-hash committee batch").digest() + b"\x01"
    M, K, S, expected = [], [], [], []
    for v in range(QUORUM):
        sig = pysigner.sign(seeds[v], msg, public_key=pks[v])
        if v % 5 == 0:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        M.append(msg), K.append(pks[v]), S.append(sig), expected.append(v % 5 != 0)
    return M, K, S, expected


def committee_votes(seed: int) -> tuple:
    """Phase 5's corpus (`_committee_corpus`), its expected mask held
    against the host verifier on every distinct triple: the signed votes and
    each corrupted lane, the identity-key forgeries included. Made before
    phase 3b, which stages these votes."""
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        corpus = seeds, pks, M, K, S, expected, lanes, identity_lanes = _committee_corpus(seed, pool)
        check = list(range(SIGNED_QCS * QUORUM)) + [int(i) for i in lanes]
        host = pool.map(_verify_one, [(K[i], M[i], S[i]) for i in check], chunksize=64)
        if [bool(v) for v in host] != [bool(expected[i]) for i in check]:
            fail("committee expected mask disagrees with the host verifier")
    print(f"committee corpus: {COMMITTEE} validators, {N_QC} QCs x {QUORUM} votes = {len(M)} votes, "
          f"{len(lanes)} corrupted lanes ({len(identity_lanes)} identity-key forgeries the device accepts), "
          f"host cross-check in {time.perf_counter() - t0:.1f} s", flush=True)
    return corpus


def phase_committee_path(corpus: tuple, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from hotstuff_tpu_torch.crypto import native_staging, pysigner
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ops import _build
    from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier

    seeds, pks, M, K, S, expected, lanes, identity_lanes = corpus
    n_signed = SIGNED_QCS * QUORUM
    table_keys = pks + _committee_special_keys()
    backend = TorchBackend(device=device, crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    t0 = time.perf_counter()
    if backend.register_committee(table_keys, warmup=True) != len(table_keys):
        fail("register_committee returned the wrong size")
    print(f"register_committee({len(table_keys)} keys, warmup=True): {time.perf_counter() - t0:.2f} s", flush=True)
    vpks, vsgs = [PublicKey(k) for k in K], [Signature(s) for s in S]
    _build.reset_launches()
    native_staging.reset_calls()
    mask = backend.verify_batch_mask(M, vpks, vsgs, committee=True)
    launches, staged = _build.launches(), native_staging.calls()
    print(f"committee path launches: {launches}; native staging calls: {staged}", flush=True)
    if mask != expected.tolist():
        bad = np.flatnonzero(np.array(mask) != expected)
        fail(f"committee mask differs from expected on {len(bad)} lanes, e.g. {bad[:8].tolist()}")
    chunks = -(-len(M) // CHUNK)
    if any(launches[k] != chunks for k in ("committee_ladder", "h_digits_idx", "compress_eq")) or any(
        launches[k] != 0 for k in ("ladder", "decompress_table", "h_digits")
    ):
        fail(f"committee path launched the wrong kernels: {launches}")
    if staged != {k: (chunks if k == "stage_committee_dh" else 0) for k in staged}:
        fail(f"the committee path did not stage each chunk natively: {staged}")
    st = backend.stats
    if st["committee_batches"] != 1 or st["committee_sigs"] != len(M) or st["host_sigs"] != 0:
        fail(f"committee batch not counted as one device committee batch: {st}")
    generic = backend.verify_batch_mask(M, vpks, vsgs)
    if generic != mask:
        fail("committee mask differs from the generic path's mask on the same batch")
    print("committee mask == expected == generic mask", flush=True)

    # Host-hash committee format: no K2 of either kind.
    HM, HK, HS, hexpected = _host_hash_votes(seeds, pks)
    _build.reset_launches()
    native_staging.reset_calls()
    hmask = backend.verify_batch_mask(HM, [PublicKey(k) for k in HK], [Signature(s) for s in HS], committee=True)
    hl = _build.launches()
    if hmask != hexpected or hl["h_digits"] or hl["h_digits_idx"] or not hl["committee_ladder"] or hl["ladder"]:
        fail(f"host-hash committee batch: mask or kernels wrong ({hl})")
    if native_staging.calls()["stage_committee_hh"] != 1:
        fail(f"the host-hash committee batch was not staged natively: {native_staging.calls()}")
    # A tagged batch with an unregistered key takes the generic kernels.
    outsider_seed = hashlib.sha256(b"outsider").digest()
    outsider = pysigner.keypair_from_seed(outsider_seed)[0]
    OM, OK, OS = M[:QUORUM], K[:QUORUM], S[:QUORUM]
    OK[-1], OS[-1] = outsider, pysigner.sign(outsider_seed, OM[-1], public_key=outsider)
    misses = backend.stats["committee_misses"]
    _build.reset_launches()
    omask = backend.verify_batch_mask(OM, [PublicKey(k) for k in OK], [Signature(s) for s in OS], committee=True)
    ol = _build.launches()
    if omask != expected[:QUORUM].tolist()[:-1] + [True] or backend.stats["committee_misses"] != misses + 1:
        fail(f"unregistered-key batch: mask or miss count wrong ({backend.stats})")
    if ol["committee_ladder"] or not (ol["ladder"] and ol["decompress_table"] and ol["h_digits"]):
        fail(f"unregistered-key batch did not take the generic kernels: {ol}")
    # A batch pinned to table t1 keeps t1's result after t2 replaces it.
    v = Ed25519TorchVerifier(device=device, max_bucket=MAX_BUCKET, chunk=CHUNK)
    t1 = v.set_committee(table_keys)
    n_pin = 2 * QUORUM
    idx_old = [t1.index[k] for k in K[:n_pin]]
    t2 = v.set_committee(list(reversed(table_keys)))
    if v.committee is not t2 or t2 is t1:
        fail("re-registration did not replace the table")
    pinned = v.verify_batch_mask_committee(M[:n_pin], idx_old, S[:n_pin], table=t1)
    if pinned.tolist() != expected[:n_pin].tolist():
        fail("a batch pinned to the replaced table changed its result")
    print("host-hash committee batch, unregistered-key miss, pinned table: ok", flush=True)

    # Votes/s of the committee and the generic path on the same votes, in turns.
    iters, times = 5, {"committee": [], "generic": []}
    for _ in range(iters):
        for path in ("committee", "generic"):
            t0 = time.perf_counter()
            again = backend.verify_batch_mask(M, vpks, vsgs, committee=path == "committee")
            torch.cuda.synchronize()
            times[path].append(time.perf_counter() - t0)
            if again != mask:
                fail(f"{path} mask changed between iterations")
    rates = {path: len(M) * iters / sum(t) for path, t in times.items()}
    for path, t in times.items():
        print(f"e2e {path}: {len(M)} votes per batch, {iters} batches: {rates[path]:.1f} votes/s "
              f"(host clock), per batch {[round(x * 1e3, 3) for x in t]} ms", flush=True)
    from hotstuff_tpu_torch import breakdown

    out = []
    trace = breakdown.device_trace(lambda: out.append(backend.verify_batch_mask(M, vpks, vsgs, committee=True)),
                                   REPO / ".chip_smoke" / "trace_committee.json")
    if out[0] != mask or trace["on_default_stream"]:
        fail(f"traced committee batch: mask changed or work on the default stream ({trace})")
    print(f"committee path pipeline: {_pipeline_line(backend._verifier)}; traced batch: card busy "
          f"{trace['busy_share']:.4f} of {trace['wall_ms']:.3f} ms, {trace['kernels']} kernels, "
          f"events per stream {trace['streams']} (default stream {trace['default_stream']}: none)", flush=True)
    identity = set(identity_lanes)
    ok_lanes = [i for i in range(len(M)) if expected[i] and i not in identity]
    crossover = phase_crossover(backend, M, K, S, expected, ok_lanes)
    qcs = (M[:n_signed], K[:n_signed], S[:n_signed], expected[:n_signed].tolist())
    return dict(launches=launches, table_keys=table_keys, rates=rates, crossover=crossover, qcs=qcs,
                votes=(M, K, S, expected))


SWEEP = (1, 2, 4, 8, 16, 32, QUORUM, 64)  # batch sizes of the crossover sweep


def _openssl_verifier():
    """OpenSSL's ed25519 verify through the `cryptography` wheel (the
    reference's `CpuBackend`), or None where the wheel is not installed.
    Timed beside the port's host verifier; the port never calls it."""
    try:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey
    except ImportError:
        return None

    def verify_batch_mask(messages, keys, signatures):
        out = []
        for m, k, s in zip(messages, keys, signatures, strict=True):
            try:
                Ed25519PublicKey.from_public_bytes(k.data).verify(s.data, m)
                out.append(True)
            except (InvalidSignature, ValueError):
                out.append(False)
        return out

    return verify_batch_mask


def phase_crossover(backend, M, K, S, expected, ok_lanes) -> dict:
    """Host-vs-card break-even. For each batch size n of SWEEP: the median
    host-clock ms of verifying n valid votes with the host verifier
    (`HostBackend`, what `TorchBackend` runs below its crossover on the
    exact route), with OpenSSL where `cryptography` imports (else "not
    available"; what it runs on the OpenSSL route), and with the card's
    committee and generic paths (`backend` has crossover 1 and the
    committee registered). A path's break-even is the least n of the sweep
    from which the card is faster at every larger n of the sweep; the
    OpenSSL route's defaults (`torch_backend.DEFAULT_CROSSOVERS`) are
    OpenSSL's break-evens. Then `check_default_routing`."""
    from hotstuff_tpu_torch.crypto.backend import HostBackend
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature

    host = HostBackend()
    openssl = _openssl_verifier()
    lanes = ok_lanes[: max(SWEEP)]
    vm, vk, vs = [M[i] for i in lanes], [PublicKey(K[i]) for i in lanes], [Signature(S[i]) for i in lanes]

    def median_ms(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    res = {"n": list(SWEEP), "host_ms": [], "openssl_ms": [] if openssl else "not available",
           "committee_ms": [], "generic_ms": []}
    for n in SWEEP:
        args = (vm[:n], vk[:n], vs[:n])
        res["host_ms"].append(median_ms(lambda: host.verify_batch_mask(*args), 3))
        if openssl:
            res["openssl_ms"].append(median_ms(lambda: openssl(*args), 5))
        res["committee_ms"].append(median_ms(lambda: backend.verify_batch_mask(*args, committee=True), 5))
        res["generic_ms"].append(median_ms(lambda: backend.verify_batch_mask(*args), 5))

    def break_even(card, host_ms):
        wins = [c < h for c, h in zip(card, host_ms)]
        return next((n for j, n in enumerate(SWEEP) if all(wins[j:])), None)

    paths = ("committee", "generic")
    res["break_even"] = {p: break_even(res[f"{p}_ms"], res["host_ms"]) for p in paths}
    res["break_even_openssl"] = (
        {p: break_even(res[f"{p}_ms"], res["openssl_ms"]) for p in paths} if openssl else "not available"
    )
    res["routing"] = check_default_routing(backend, M, K, S, expected, ok_lanes)
    print(f"crossover sweep: {json.dumps(res)}", flush=True)
    return res


def routing_lanes(expected, ok_lanes) -> list[int]:
    """The routing check's lanes: rejected and valid lanes in turns, then
    valid ones, so that every size of SWEEP holds a rejected lane."""
    bad = [i for i in range(len(expected)) if not expected[i]][:8]
    return [i for pair in zip(bad, ok_lanes) for i in pair] + list(ok_lanes[len(bad):max(SWEEP)])


def check_default_routing(card, M, K, S, expected, ok_lanes) -> dict:
    """`TorchBackend` at its default crossovers (`card`'s committee
    registered) on each size n of SWEEP, tagged and untagged: below the
    path's default the batch must go to the host route (`stats` host lanes
    and `verifier.crossover_fallbacks` move by the batch), at or above it
    to the card, and either way the mask must be `card`'s (crossover 1) and
    the expected one. Returns the defaults and the sizes sent to the host."""
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.utils import metrics

    lanes = routing_lanes(expected, ok_lanes)
    default = TorchBackend(device=card.device, max_bucket=MAX_BUCKET, chunk=CHUNK)
    default.register_committee(card._verifier.committee.keys)
    fallbacks = metrics.counter("verifier.crossover_fallbacks")
    out = {"crossover": default.crossover, "committee_crossover": default.committee_crossover,
           "host_route": default.host_route, "host": {"generic": [], "committee": []}}
    try:
        for n in SWEEP:
            args = ([M[i] for i in lanes[:n]], [PublicKey(K[i]) for i in lanes[:n]],
                    [Signature(S[i]) for i in lanes[:n]])
            want = [bool(expected[i]) for i in lanes[:n]]
            for path, threshold in (("generic", default.crossover), ("committee", default.committee_crossover)):
                tagged = path == "committee"
                host0, f0 = default.stats["host_sigs"], fallbacks.value
                mask = default.verify_batch_mask(*args, committee=tagged)
                on_host = default.stats["host_sigs"] - host0 == n and fallbacks.value - f0 == 1
                if on_host != (n < threshold):
                    fail(f"default backend: a {path} batch of {n} went to the "
                         f"{'host' if on_host else 'card'} at crossover {threshold}: {default.stats}")
                if mask != card.verify_batch_mask(*args, committee=tagged) or mask != want:
                    fail(f"default backend: a {path} batch of {n} on the {'host' if on_host else 'card'} "
                         f"gave another mask than the card's")
                if on_host:
                    out["host"][path].append(n)
    finally:
        default.close()
    print(f"default routing: crossover {out['crossover']}, committee_crossover {out['committee_crossover']}, "
          f"host route {out['host_route']}; the sizes sent to the host ({out['host']}) gave the card's masks",
          flush=True)
    return out


# --- phase 5b: the sharded verifier on a mesh -----------------------------------

MESH_ATTEMPTS = 3  # in turns with the single-device backend; medians
MESH_ITERS = 3  # batches per attempt, leg and path
COMMITTEE_KERNELS = ("h_digits_idx", "committee_ladder", "compress_eq")
UNPACKED_KERNELS = ("decompress_table", "ladder", "compress_eq")  # packed=False, kernel "w4": K3, K1, K4


def meshes(device: str = "cuda") -> dict:
    """The meshes of the phase: every visible GPU (`default_mesh()`; on the
    CPU one shard), then virtual meshes of 2 and 4 shards on the first
    device (`cuda:0`)."""
    from hotstuff_tpu_torch.parallel import default_mesh

    gpus = default_mesh() if device == "cuda" else default_mesh(device=device)
    first = gpus.devices[0]
    kind = "GPU" if first.type == "cuda" else "CPU"
    return {f"{gpus.size} {kind}": gpus, "virtual 2": default_mesh(2, device=first),
            "virtual 4": default_mesh(4, device=first)}


def mesh_launch_errors(launches: dict, single: dict, kernels, shards: int) -> list[str]:
    """Where a mesh run's launch counts are not `shards` times the
    single-device run's for `kernels`, and not 0 for every other kernel."""
    bad = [f"{k}: {launches[k]} != {shards} x {single[k]}" for k in kernels if launches[k] != shards * single[k]]
    return bad + [f"{k}: {n} launches off the path" for k, n in launches.items() if n and k not in kernels]


def qc_wire(qcs, quorum: int, n_dp: int):
    """Phase 5's signed QCs (QC q = votes [q quorum, (q + 1) quorum)) as a
    QC-major (Q, 128, B) device-hash wire batch for `sharded_qc_counts`,
    staged by the native plane (the verifier's default staging),
    each QC padded to B, a multiple of n_dp, with copies of its first vote
    whose s < L bit is off. Returns (packed, s_ok, expected masks (Q, B),
    expected counts (Q,))."""
    import numpy as np

    from hotstuff_tpu_torch.crypto import native_staging

    M, K, S, expected = qcs
    n_q = len(M) // quorum
    width = -(-quorum // n_dp) * n_dp
    n = n_q * quorum
    staged = native_staging.stage_packed_dh(M[:n], K[:n], S[:n], np.empty((1, 128, n), np.uint8), n, 1)
    packed = staged["packed"][0].reshape(128, n_q, quorum).transpose(1, 0, 2)
    s_ok = staged["s_ok"].reshape(n_q, quorum)
    want = np.asarray(expected[: n_q * quorum], bool).reshape(n_q, quorum)
    pad = width - quorum
    packed = np.concatenate([packed, np.repeat(packed[:, :, :1], pad, axis=2)], axis=2)
    s_ok = np.concatenate([s_ok, np.zeros((n_q, pad), bool)], axis=1)
    want = np.concatenate([want, np.zeros((n_q, pad), bool)], axis=1)
    return np.ascontiguousarray(packed), s_ok, want, want.sum(axis=1)


def _mesh_run(label: str, mesh, single, batch, votes, table_keys, main_launches, committee_launches) -> dict:
    """One mesh against the single-device backend `single` (see
    `phase_mesh`)."""
    import torch

    from hotstuff_tpu_torch import breakdown
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ops import _build
    from hotstuff_tpu_torch.utils import metrics

    M, K, S, expected = batch
    CM, CK, CS, cexpected = votes
    pks, sgs = [PublicKey(k) for k in K], [Signature(s) for s in S]
    cpks, csgs = [PublicKey(k) for k in CK], [Signature(s) for s in CS]
    allocs = metrics.counter("pipeline.buffer_allocs")
    decomp, builds = metrics.counter("verifier.decompressions"), metrics.counter("verifier.table_builds")
    backend = TorchBackend(mesh=mesh, crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    v, n = backend._verifier, mesh.size
    try:
        backend.warmup()
        d0, b0 = decomp.value, builds.value
        backend.register_committee(table_keys, warmup=True)
        table = v.committee
        if (decomp.value, builds.value) != (d0, b0):
            fail(f"mesh {label}: registration counted decompressions or table builds")
        replicas = table.replicas
        if list(replicas) != list(mesh.distinct) or any(
                r.entries.device != d or not torch.equal(r.entries.cpu(), table.entries.cpu())
                for d, r in replicas.items()):
            fail(f"mesh {label}: replicas {list(replicas)} are not one equal table per device of {mesh.distinct}")
        _top_up(v.pipeline)
        a0, st0 = allocs.value, dict(backend.stats)
        _build.reset_launches()
        mask = backend.verify_batch_mask(M, pks, sgs)
        launches = _build.launches()
        bad = mesh_launch_errors(launches, main_launches, GENERIC_KERNELS, n)
        if mask != expected.tolist() or bad:
            fail(f"mesh {label}: generic mask equal to expected: {mask == expected.tolist()}; launches {bad}")
        _build.reset_launches()
        d0, b0 = decomp.value, builds.value
        cmask = backend.verify_batch_mask(CM, cpks, csgs, committee=True)
        claunches = _build.launches()
        bad = mesh_launch_errors(claunches, committee_launches, COMMITTEE_KERNELS, n)
        if cmask != cexpected.tolist() or bad or (decomp.value, builds.value) != (d0, b0):
            fail(f"mesh {label}: committee mask equal to expected: {cmask == cexpected.tolist()}; launches "
                 f"{bad}; decompressions {decomp.value - d0}, table builds {builds.value - b0}")

        legs = {"single": single, "mesh": backend}
        rates = {leg: {"generic": [], "committee": []} for leg in legs}
        for _ in range(MESH_ATTEMPTS):
            for leg, b in legs.items():
                for path, args, want in (("generic", (M, pks, sgs), mask), ("committee", (CM, cpks, csgs), cmask)):
                    d0, b0 = decomp.value, builds.value
                    t0 = time.perf_counter()
                    outs = [b.verify_batch_mask(*args, committee=path == "committee") for _ in range(MESH_ITERS)]
                    rates[leg][path].append(len(args[0]) * MESH_ITERS / (time.perf_counter() - t0))
                    if any(o != want for o in outs):
                        fail(f"mesh {label}: a timed {leg} {path} mask differs")
                    if path == "committee" and (decomp.value, builds.value) != (d0, b0):
                        fail(f"mesh {label}: timed {leg} committee batches decompressed or built tables")
        if allocs.value != a0:
            fail(f"mesh {label}: {allocs.value - a0} staging buffers allocated after warm-up")
        if backend.stats["host_sigs"] != st0["host_sigs"]:
            fail(f"mesh {label}: lanes verified on the host: {backend.stats}")
        traced = {}
        for leg, b in legs.items():
            for path, args in (("generic", (M, pks, sgs)), ("committee", (CM, cpks, csgs))):
                out = []
                trace_path = REPO / ".chip_smoke" / f"trace_mesh_{label.replace(' ', '')}_{leg}_{path}.json"
                tr = breakdown.device_trace(
                    lambda: out.append(b.verify_batch_mask(*args, committee=path == "committee")), trace_path)
                if out[0] != (mask if path == "generic" else cmask) or tr["on_default_stream"]:
                    fail(f"mesh {label}: traced {leg} {path} batch: mask changed or work on the default stream ({tr})")
                traced[f"{leg}_{path}"] = tr
        pipeline = _pipeline_line(v)
    finally:
        backend.close()
    med = {leg: {p: statistics.median(r) for p, r in paths.items()} for leg, paths in rates.items()}
    return dict(
        devices=[str(d) for d in mesh.devices], staging=v.staging, replicas=len(replicas), launches=launches,
        committee_launches=claunches,
        sigs_per_s={leg: {p: [round(x, 1) for x in r] for p, r in paths.items()} for leg, paths in rates.items()},
        median={leg: {p: round(x, 1) for p, x in paths.items()} for leg, paths in med.items()},
        ratio={p: round(med["mesh"][p] / med["single"][p], 3) for p in ("generic", "committee")},
        busy_share={k: round(tr["busy_share"], 4) for k, tr in traced.items()},
        streams={k: tr["streams"] for k, tr in traced.items()}, pipeline=pipeline)


def _shard_kernel_ms(v, batch, votes, table_keys, width: int, kernels: dict, committee_kernels: dict) -> dict:
    """Each kernel's device ms at one shard's width (`breakdown`'s layer
    timers on the first `width` lanes of each batch), their sums per path,
    the bound of each sum (the per-kernel bounds of phases 2 and 5 scaled
    from LANES to `width` lanes, summed), and the plain versions' ms at that
    width (`_shard_plain_ms`) with their sum."""
    from hotstuff_tpu_torch import breakdown

    M, K, S, _ = batch
    CM, CK, CS, _ = votes
    table = v.set_committee(table_keys)
    gl = breakdown._generic_layers(v, M, K, S, width)
    cl = breakdown._committee_layers(v, table, CM, [table.index[k] for k in CK], CS, width)
    plain = _shard_plain_ms(v, batch, votes, table_keys, width)
    rows = {**kernels, **committee_kernels}
    out = {}
    for path, layers, names in (("generic", gl, GENERIC_KERNELS), ("committee", cl, COMMITTEE_KERNELS)):
        ms = {k: layers[f"{k}_ms"] for k in names}
        bounds = [_bound_ms(rows[k]["bytes"] * width / LANES, rows[k]["ops"] * width / LANES) for k in names]
        out[path] = dict(ms={k: round(x, 4) for k, x in ms.items()}, sum_ms=round(sum(ms.values()), 4),
                         bound_ms=round(sum(b for b, _ in bounds), 5),
                         plain_ms={k: round(x, 1) for k, x in plain[path].items()},
                         plain_sum_ms=round(sum(plain[path].values()), 1))
    return out


def _shard_plain_ms(v, batch, votes, table_keys, width: int) -> dict:
    """Each path's plain versions, one call each (CUDA events, `_plain_ms`),
    on the first `width` lanes of phase 3's batch and phase 5's votes,
    staged as the verifier stages them, on its device: path -> kernel -> ms."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops import committee as cm
    from hotstuff_tpu_torch.ops import ed25519 as ed
    from hotstuff_tpu_torch.ops import ladder, sha512

    M, K, S, _ = batch
    CM, CK, CS, _ = votes
    ct = v.set_committee(table_keys)
    idx_list = [ct.index[k] for k in CK[:width]]
    out = np.empty((1, 128, width), np.uint8)
    v.stage_wire("generic", True, (M[:width], K[:width], S[:width]), out)
    a, r, s, m = ed.split_packed128(torch.from_numpy(out[0]).to(v.device))
    sd = sha512.nibble_rows(s)
    g = {}
    g["h_digits"], hd = _plain_ms(lambda: sha512.h_digits_plain(r, a, m))
    g["decompress_table"], (table, valid) = _plain_ms(lambda: ed.decompress_table_plain(a))
    g["ladder"], point = _plain_ms(lambda: ladder.ladder_plain(sd, hd, table))
    g["compress_eq"], _ = _plain_ms(lambda: ed.compress_eq_plain(point, r, valid))
    out = np.empty((1, 96, width), np.uint8)
    v.stage_wire("committee", True, (CM[:width], idx_list, CS[:width]), out)
    r, s, m = cm.split_packed96(torch.from_numpy(out[0]).to(v.device))
    idx = torch.tensor(idx_list, dtype=torch.int32, device=v.device)
    sd = sha512.nibble_rows(s)
    c = {}
    c["h_digits_idx"], hd = _plain_ms(lambda: sha512.h_digits_gather_plain(r, ct.keys_u8, idx, m))
    c["committee_ladder"], (point, lane_valid) = _plain_ms(
        lambda: cm.committee_ladder_plain(sd, hd, ct.entries, ct.valid, idx))
    c["compress_eq"], _ = _plain_ms(lambda: ed.compress_eq_plain(point, r, lane_valid))
    return {"generic": g, "committee": c}


def phase_mesh(batch, committee_path: dict, main_launches: dict, kernels: dict, committee_kernels: dict,
               card: str, device: str = "cuda") -> dict:
    """The sharded verifier (`hotstuff_tpu_torch/parallel/mesh.py`) on every
    mesh of `meshes()`, with phase 3's generic batch and phase 5's committee
    votes (see the module docstring); then `sharded_qc_counts` on a virtual
    2 x 2 mesh over phase 5's signed QCs, and the sidecar CLI with
    `--sharded --committee` answering one QC."""
    import torch

    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.remote import RemoteBackend
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ops import _build
    from hotstuff_tpu_torch.parallel import mesh_2d, sharded_qc_counts

    run_dir = REPO / ".chip_smoke" / "mesh"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    table_keys = committee_path["table_keys"]
    cli_log = run_dir / "sidecar-cli.log"
    cli = None
    if device == "cuda":
        # The table's keys as a committee's authorities; no node listens on the ports.
        names = [base64.standard_b64encode(k).decode() for k in table_keys]
        committee_file, _ = write_node_configs(run_dir, names, list(range(9000, 9000 + 3 * len(names))))
        cli = _spawn([sys.executable, "-m", "hotstuff_tpu_torch.crypto.remote", "-vv", "--port", "0", "--sharded",
                      "--committee", str(committee_file)], cli_log, run_dir)
    single = TorchBackend(device=device, crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    try:
        single.warmup()
        single.register_committee(table_keys, warmup=True)
        _top_up(single._verifier.pipeline)
        results = {}
        for label, mesh in meshes(device).items():
            res = results[label] = _mesh_run(label, mesh, single, batch, committee_path["votes"], table_keys,
                                              main_launches, committee_path["launches"])
            res["shard_kernels"] = _shard_kernel_ms(single._verifier, batch, committee_path["votes"], table_keys,
                                                    CHUNK // mesh.size, kernels, committee_kernels)
            print(f"mesh {label}: devices {res['devices']}, {res['replicas']} table replica(s); generic and committee "
                  f"masks == expected == single-device masks; launches {res['launches']} and "
                  f"{res['committee_launches']} (= {mesh.size} x single-device); 0 host lanes; committee batches "
                  f"decompressed nothing and built no table; no staging buffer allocated after warm-up; nothing on "
                  f"the default stream; pipeline {res['pipeline']}", flush=True)
            print(f"mesh timing {label} ({card}, {res['staging']} staging): {MESH_ATTEMPTS} attempts x "
                  f"{MESH_ITERS} batches in turns with one device: sigs/s {json.dumps(res['sigs_per_s'])}, "
                  f"medians {json.dumps(res['median'])}, "
                  f"mesh / single {json.dumps(res['ratio'])}; busy share {json.dumps(res['busy_share'])}; "
                  f"per-shard kernels at {CHUNK // mesh.size} lanes {json.dumps(res['shard_kernels'])}", flush=True)

        qmesh = mesh_2d(2, 2, devices=[single.device] * 4)
        packed, s_ok, qwant, qcounts = qc_wire(committee_path["qcs"], QUORUM, qmesh.shape["dp"])
        _build.reset_launches()
        qmask, counts = sharded_qc_counts(qmesh, packed, s_ok)
        qlaunches = _build.launches()
        if qmask.cpu().numpy().tolist() != qwant.tolist() or counts.cpu().tolist() != qcounts.tolist():
            fail(f"sharded_qc_counts on {qmesh}: masks or counts differ from expected")
        if device == "cuda" and mesh_launch_errors(qlaunches, dict.fromkeys(GENERIC_KERNELS, 1), GENERIC_KERNELS, 4):
            fail(f"sharded_qc_counts launched {qlaunches}, not each generic kernel once per device")
        print(f"mesh qc counts: {qmesh}: {packed.shape[0]} QCs x {packed.shape[2]} lanes ({QUORUM} votes and "
              f"padding), masks and per-QC counts == expected (counts {counts.cpu().tolist()[:8]}...), "
              f"launches {qlaunches}", flush=True)

        if cli is not None:
            _await_logs([(cli_log, cli)], "successfully booted", "the sharded sidecar CLI")
            text = cli_log.read_text()
            cli_port = int(re.search(r"successfully booted on [\d.]+:(\d+)", text).group(1))
            client = RemoteBackend(("127.0.0.1", cli_port), crossover=1)
            QM, QK, QS, qexp = committee_path["qcs"]
            cmask = client.verify_batch_mask(QM[:QUORUM], [PublicKey(k) for k in QK[:QUORUM]],
                                             [Signature(s) for s in QS[:QUORUM]])
            client.close()
            if cmask != qexp[:QUORUM] or client.stats["remote_sigs"] != QUORUM:
                fail(f"the sharded sidecar CLI answered a QC wrongly: {client.stats}")
            registered = f"registered {len(set(table_keys))}-key committee"
            if registered not in text or "batches split over DeviceMesh" not in text:
                fail(f"the sharded sidecar CLI did not split batches or register the committee; see {cli_log}")
            print(f"sidecar CLI --sharded --committee: booted on {torch.cuda.device_count()} GPU(s), one "
                  f"{QUORUM}-vote QC answered with the expected mask", flush=True)
    finally:
        if cli is not None:
            _kill([cli])
        single.close()
    return dict(meshes=results, qc_launches=qlaunches)


# --- phase 5c: the multi-process mesh -----------------------------------------

MULTIHOST_SHARDS = 2  # each rank's virtual shards on cuda:0: a 2 x 2 global mesh
MULTIHOST_UNPACKED = 4096  # lanes of the packed=False batch (one f32 piece)
MULTIHOST_ITERS = 3  # timed generic batches a rank, and of the one-process backend
MULTIHOST_TIMEOUT_S = 180  # the workers' and the sidecars' limit, each


def multihost_worker(rank: int, run_dir: Path) -> int:
    """One rank of phase 5c (`python3 chip_smoke.py --multihost-worker
    RANK --multihost-dir DIR`, with MASTER_ADDR, MASTER_PORT and WORLD_SIZE
    in the environment): joins the job, runs the phase's batches and writes
    `rank<RANK>.json` in DIR. Any failure raises."""
    import pickle

    import numpy as np

    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ops import _build
    from hotstuff_tpu_torch.parallel import ShardedEd25519TorchVerifier, init_multihost
    from hotstuff_tpu_torch.parallel.mesh import LANE
    from hotstuff_tpu_torch.utils import metrics

    with open(run_dir / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    M, K, S = inputs["batch"]
    CM, CK, CS = inputs["votes"]
    device = inputs["device"]
    if device == "cuda" and not _build.all_built():
        fail("a multihost worker found the kernels unbuilt (phase 1 builds them)")
    mesh = init_multihost(os.environ["MASTER_ADDR"] + ":" + os.environ["MASTER_PORT"], 2, rank,
                          device="cuda:0" if device == "cuda" else device, local_shards=MULTIHOST_SHARDS)
    if mesh.ranks != (0,) * MULTIHOST_SHARDS + (1,) * MULTIHOST_SHARDS:
        fail(f"rank {rank}: the global mesh is {mesh}")
    gathers, gather_s = metrics.counter("mesh.gathers"), metrics.histogram("mesh.gather_s")
    backend = TorchBackend(mesh=mesh, crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    v = backend._verifier
    if not v._defer_readback or v.pipeline.depth != 1 or v.mesh_alignment != LANE * mesh.size:
        fail(f"rank {rank}: the verifier is not in multi-process mode ({v.pipeline.depth}, {v.mesh_alignment})")
    backend.register_committee(inputs["table_keys"])
    pks, sgs = [PublicKey(k) for k in K], [Signature(s) for s in S]
    cpks, csgs = [PublicKey(k) for k in CK], [Signature(s) for s in CS]
    unpacked = ShardedEd25519TorchVerifier(mesh=mesh, packed=False, max_bucket=MAX_BUCKET, chunk=CHUNK)
    out = {"rank": rank, "mesh": repr(mesh), "masks": {}, "launches": {}, "gathers": {}}
    n = MULTIHOST_UNPACKED
    legs = (("generic", lambda: backend.verify_batch_mask(M, pks, sgs)),
            ("committee", lambda: backend.verify_batch_mask(CM, cpks, csgs, committee=True)),
            ("unpacked", lambda: unpacked.verify_batch_mask(M[:n], K[:n], S[:n])))
    for leg, run in legs:
        _build.reset_launches()
        g0 = gathers.value
        mask = np.asarray(run(), bool)
        out["launches"][leg] = {k: n for k, n in _build.launches().items() if n}
        out["gathers"][leg] = gathers.value - g0
        out["masks"][leg] = np.packbits(mask).tobytes().hex()
    if backend.stats["host_sigs"]:
        fail(f"rank {rank}: lanes verified on the host: {backend.stats}")
    g0, s0 = gathers.value, gather_s.summary()["sum"]
    t0 = time.perf_counter()
    for _ in range(MULTIHOST_ITERS):
        backend.verify_batch_mask(M, pks, sgs)
    wall = time.perf_counter() - t0
    out["timed"] = {"sigs_per_s": len(M) * MULTIHOST_ITERS / wall, "gathers": gathers.value - g0,
                    "gather_ms": (gather_s.summary()["sum"] - s0) * 1e3 / max(1, gathers.value - g0)}
    unpacked.close()
    backend.close()
    if {"jax", "hotstuff_tpu"} & set(sys.modules):
        fail(f"rank {rank} imported JAX or the JAX package")
    (run_dir / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def _wait_all(procs: list, logs: list[Path], what: str) -> None:
    """Until every process exits; fails when one exits non-zero or the
    phase's limit passes (every process is killed first)."""
    deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
    try:
        for proc, log in zip(procs, logs):
            proc.wait(max(0.0, deadline - time.monotonic()))
            if proc.returncode != 0:
                fail(f"{what} exited with rc {proc.returncode}; see {log}:\n{log.read_text()[-3000:]}")
    except subprocess.TimeoutExpired:
        fail(f"{what} outlived {MULTIHOST_TIMEOUT_S} s (a collective out of step?); see {[str(p) for p in logs]}")
    finally:
        _kill([p for p in procs if p.poll() is None])


def multihost_errors(res: dict, expected: dict, chunks: dict) -> list[str]:
    """What in one rank's result is not the phase's: a mask that is not the
    one-process backend's, a leg that launched a kernel off its path or its
    path's kernels other than chunks x the rank's shards, or a batch that did
    not end in exactly one gather."""
    import numpy as np

    bad = []
    kernels = {"generic": GENERIC_KERNELS, "committee": COMMITTEE_KERNELS, "unpacked": UNPACKED_KERNELS}
    for leg, want in expected.items():
        mask = np.unpackbits(np.frombuffer(bytes.fromhex(res["masks"][leg]), np.uint8))[: len(want)].astype(bool)
        if mask.tolist() != np.asarray(want, bool).tolist():
            bad.append(f"{leg}: mask differs on {int((mask != np.asarray(want, bool)).sum())} lanes")
        launches = {k: n for k, n in res["launches"][leg].items() if n}
        if chunks[leg] is not None and launches != dict.fromkeys(kernels[leg], chunks[leg] * MULTIHOST_SHARDS):
            bad.append(f"{leg}: launches {launches}, not {chunks[leg]} x {MULTIHOST_SHARDS} of {kernels[leg]}")
        if res["gathers"][leg] != 1:
            bad.append(f"{leg}: {res['gathers'][leg]} gathers")
    if res["timed"]["gathers"] != MULTIHOST_ITERS:
        bad.append(f"timed: {res['timed']['gathers']} gathers for {MULTIHOST_ITERS} batches")
    return [f"rank {res['rank']}: {b}" for b in bad]


def _lock_step(clients: list, args: tuple) -> list:
    """The same request to every client at once (each sidecar's answer
    waits in a gather for the others); their answers."""
    import threading

    answers: list = [None] * len(clients)

    def ask(i: int) -> None:
        answers[i] = clients[i].verify_batch_mask(*args)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(MULTIHOST_TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        fail("a multihost sidecar never answered")
    return answers


def phase_multihost(batch, committee_path: dict, card: str, device: str = "cuda") -> dict:
    """Phase 5c (see the module docstring). Returns each rank's launches of
    each kernel, over the three legs. On the CPU (a rehearsal) nothing
    launches, so the launch counts are not held, and the sidecars run the
    plain versions without a warm-up."""
    import pickle

    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.remote import RemoteBackend
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend

    M, K, S, expected = batch
    CM, CK, CS, cexpected = committee_path["votes"]
    table_keys = committee_path["table_keys"]
    run_dir = REPO / ".chip_smoke" / "multihost"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    with open(run_dir / "inputs.pkl", "wb") as f:
        pickle.dump({"batch": (M, K, S), "votes": (CM, CK, CS), "table_keys": table_keys, "device": device}, f)

    single = TorchBackend(device=device, crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    pks, sgs = [PublicKey(k) for k in K], [Signature(s) for s in S]
    try:
        if single.verify_batch_mask(M, pks, sgs) != expected.tolist():
            fail("the one-process backend's mask differs from phase 3's")
        t0 = time.perf_counter()
        for _ in range(MULTIHOST_ITERS):
            single.verify_batch_mask(M, pks, sgs)
        single_rate = len(M) * MULTIHOST_ITERS / (time.perf_counter() - t0)
    finally:
        single.close()

    coordinator = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_ports(1)[0]), "WORLD_SIZE": "2"}
    logs = [run_dir / f"rank{r}.log" for r in range(2)]
    t0 = time.perf_counter()
    procs = [_spawn([sys.executable, str(REPO / "chip_smoke.py"), "--multihost-worker", str(r),
                     "--multihost-dir", str(run_dir)], logs[r], REPO, env=coordinator) for r in range(2)]
    _wait_all(procs, logs, "a multihost worker")
    worker_s = time.perf_counter() - t0
    results = [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(2)]
    on_card = device == "cuda"
    chunks = {"generic": -(-len(M) // CHUNK), "committee": -(-len(CM) // CHUNK), "unpacked": 1}
    if not on_card:
        chunks = dict.fromkeys(chunks)
    want = {"generic": expected, "committee": cexpected, "unpacked": expected[:MULTIHOST_UNPACKED]}
    bad = [e for res in results for e in multihost_errors(res, want, chunks)]
    if bad:
        fail(f"multihost: {bad}")
    launches = {}
    for res in results:
        total = launches[f"rank {res['rank']}"] = {}
        for leg in res["launches"].values():
            for k, n in leg.items():
                total[k] = total.get(k, 0) + n
        print(f"multihost rank {res['rank']} ({res['mesh']}): generic, committee and packed=False masks == the "
              f"one-process backend's lane for lane; launches {json.dumps(res['launches'])} (chunks x "
              f"{MULTIHOST_SHARDS} own shards); one gather a batch", flush=True)
    rates = [res["timed"]["sigs_per_s"] for res in results]
    print(f"multihost timing ({card}): gather ms a batch {[round(r['timed']['gather_ms'], 3) for r in results]}; "
          f"{len(M)}-signature batches x {MULTIHOST_ITERS}: two processes {[round(x, 1) for x in rates]} sigs/s "
          f"against the one-process backend's {single_rate:.1f} sigs/s (two processes sharing one card: the cost "
          f"of the split, not a scaling figure); workers {worker_s:.1f} s from spawn to exit", flush=True)

    names = [base64.standard_b64encode(k).decode() for k in table_keys]
    committee_file, _ = write_node_configs(run_dir, names, list(range(9000, 9000 + 3 * len(names))))
    ports = free_adjacent_ports(2)
    coordinator["MASTER_PORT"] = str(_free_ports(1)[0])
    logs = [run_dir / f"sidecar{r}.log" for r in range(2)]
    t0 = time.perf_counter()
    cpu_flags = [] if on_card else ["--device", "cpu", "--no-warmup"]
    procs = [_spawn([sys.executable, "-m", "hotstuff_tpu_torch.crypto.remote", "-vv", "--port", str(ports[r]),
                     "--multihost", "--committee", str(committee_file), *cpu_flags], logs[r], run_dir,
                    env={**coordinator, "RANK": str(r)}) for r in range(2)]
    try:
        _await_logs(list(zip(logs, procs)), "successfully booted", "the multihost sidecars")
        boot_s = time.perf_counter() - t0
        clients = [RemoteBackend(("127.0.0.1", p), crossover=1) for p in ports]
        request = min(SIDECAR_REQUEST, len(M) // 2)
        genuine = [i for i in range(len(M)) if expected[i]][:request]
        forged = list(range(len(M) - request, len(M)))
        if expected[forged].all():
            fail("the forged request has no forged lane")
        for lanes in (genuine, forged):
            args = ([M[i] for i in lanes], [PublicKey(K[i]) for i in lanes], [Signature(S[i]) for i in lanes])
            answers = _lock_step(clients, args)
            if not answers[0] == answers[1] == expected[lanes].tolist():
                fail(f"the multihost sidecars answered {[a == expected[lanes].tolist() for a in answers]} "
                     f"(equal to the expected mask)")
        for c in clients:
            c.close()
            if c.stats["remote_sigs"] != 2 * request:
                fail(f"a multihost sidecar's client verified lanes itself: {c.stats}")
        for log in logs:
            text = log.read_text()
            if f"registered {len(set(table_keys))}-key committee" not in text or "ranks [0, 1]" not in text:
                fail(f"a multihost sidecar did not join the job or register the committee; see {log}")
    finally:
        _kill(procs)
    print(f"multihost sidecars --multihost --committee on ports {ports}: booted (warm-up and registration "
          f"included) in {boot_s:.1f} s; each sent the same two {request}-item requests (genuine, "
          f"{int((~expected[forged]).sum())} forged lanes) in lock step; both answered the same bytes, the "
          f"expected masks", flush=True)
    return dict(launches=launches, single_rate=single_rate, rates=rates, boot_s=boot_s)


def free_adjacent_ports(n: int) -> list[int]:
    """n consecutive ports that are free now."""
    while True:
        base = _free_ports(1)[0]
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return list(range(base, base + n))
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()


# --- phases 6 and 7: the crypto sidecar --------------------------------------

SIDECAR_REQUEST = 976  # items per bulk request: one 500,000 B payload of 512 B transactions
SIDECAR_PASS = 32_768  # distinct triples per timed pass
SIDECAR_PASSES = 3
# One more pass of distinct triples, under torch.profiler, for the card's
# busy share; it is timed apart and not in the median.
SIDECAR_TRACED = 1
SIDECAR_CONNECTIONS = 4  # bulk connections, one per node of the 4-node local committee
SIDECAR_KEYS = 1024
URGENT_PER_PASS = SIGNED_QCS // SIDECAR_PASSES  # 43-vote requests on the urgent connection

# The reference's local benchmark (benchmark/fabfile.py:22-43): 4 nodes,
# 1,000 tx/s of 512 B for 20 s, and its node parameters, here with the
# mempool's synthetic verification workload on.
LOCAL_BENCH = {"nodes": 4, "rate": 1_000, "tx_size": 512, "duration": 20}
LOCAL_NODE_PARAMS = {
    "consensus": {
        "timeout_delay": 1_000,
        "sync_retry_delay": 10_000,
        "max_payload_size": 1_000,
        "min_block_delay": 0,
    },
    "mempool": {
        "queue_capacity": 10_000,
        "sync_retry_delay": 10_000,
        "max_payload_size": 15_000,
        "min_block_delay": 0,
        "benchmark_mode": True,
    },
}
BOOT_TIMEOUT_S = 120


def _openssl_sign(args: tuple[bytes, list[bytes]]) -> tuple[bytes, list[bytes]]:
    """Sign each message with the ed25519 key of `seed` through OpenSSL
    (the `cryptography` wheel). Returns (public key, signatures)."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
    from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

    seed, msgs = args
    sk = Ed25519PrivateKey.from_private_bytes(seed)
    return sk.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw), [sk.sign(m) for m in msgs]


def _sidecar_corpus(seed: int, pool):
    """(SIDECAR_PASSES + SIDECAR_TRACED) x SIDECAR_PASS distinct triples over distinct 32-byte messages, lane i signed by
    key i mod SIDECAR_KEYS through OpenSSL, a seeded ~1/16 of lanes corrupted
    (`_corrupt_lanes`). The expected mask is held against OpenSSL on every
    corrupted lane and every 64th lane. Returns (M, K, S, expected)."""
    import numpy as np

    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature

    n, n_keys = (SIDECAR_PASSES + SIDECAR_TRACED) * SIDECAR_PASS, SIDECAR_KEYS
    rng = np.random.default_rng(seed + 20)
    seeds = [bytes(row) for row in rng.integers(0, 256, (n_keys, 32), np.uint8)]
    M = [bytes(row) for row in rng.integers(0, 256, (n, 32), np.uint8)]
    signed = pool.map(_openssl_sign, [(seeds[j], M[j::n_keys]) for j in range(n_keys)], chunksize=16)
    K, S = [b""] * n, [b""] * n
    for j, (pk, sigs) in enumerate(signed):
        K[j::n_keys] = [pk] * len(sigs)
        S[j::n_keys] = sigs
    lanes = np.sort(rng.choice(n, n // 16, replace=False))
    expected = _corrupt_lanes(M, K, S, lanes)
    if len(set(zip(M, K, S))) != n:
        fail("the sidecar corpus repeats a triple")
    check = sorted({int(i) for i in lanes} | set(range(0, n, 64)))
    got = _openssl_verifier()([M[i] for i in check], [PublicKey(K[i]) for i in check],
                              [Signature(S[i]) for i in check])
    if got != [bool(expected[i]) for i in check]:
        fail("the sidecar corpus's expected mask disagrees with OpenSSL")
    return M, K, S, expected


def _requests(M, K, S, expected, lo: int, hi: int) -> list:
    """Lanes [lo, hi) cut into requests of SIDECAR_REQUEST: (msgs, keys,
    sigs, expected mask as a list)."""
    return [(M[a:b], K[a:b], S[a:b], [bool(x) for x in expected[a:b]])
            for a in range(lo, hi, SIDECAR_REQUEST) for b in [min(a + SIDECAR_REQUEST, hi)]]


def _client_loop(conn, port: int) -> None:
    """One sidecar connection in its own process: a RemoteBackend
    (crossover 1) sends each job's requests back to back and sends back
    the lanes whose mask differs from the expected one, each request's
    send and reply times, the first send and the last reply
    (time.monotonic, one clock for every process of the host) and the
    client's stats. A None job ends the loop."""
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.remote import RemoteBackend

    client = RemoteBackend(("127.0.0.1", port), crossover=1)
    conn.send("ready")
    while (requests := conn.recv()) is not None:
        wrapped = [(m, [PublicKey(k) for k in ks], [Signature(s) for s in ss], want)
                   for m, ks, ss, want in requests]
        bad, times = 0, []
        t0 = time.monotonic()
        for m, ks, ss, want in wrapped:
            t = time.monotonic()
            mask = client.verify_batch_mask(m, ks, ss)
            times.append((t, time.monotonic()))
            bad += sum(a != b for a, b in zip(mask, want)) + abs(len(mask) - len(want))
        conn.send(dict(bad=bad, times=times, t0=t0, t1=time.monotonic(), stats=dict(client.stats)))
    client.close()


class _Clients:
    """`n` load-generator processes, one sidecar connection each."""

    def __init__(self, port: int, n: int) -> None:
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        for _ in range(n):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_client_loop, args=(child, port), daemon=True)
            proc.start()
            self.conns.append(parent)
            self.procs.append(proc)
        for conn in self.conns:
            if not conn.poll(BOOT_TIMEOUT_S) or conn.recv() != "ready":
                fail("a load-generator process did not start")

    def run(self, jobs: list) -> list[dict]:
        for conn, job in zip(self.conns, jobs):
            conn.send(job)
        out = []
        for conn in self.conns:
            if not conn.poll(600):
                fail("a load-generator process did not answer")
            out.append(conn.recv())
        return out

    def close(self) -> None:
        for conn, proc in zip(self.conns, self.procs):
            try:
                conn.send(None)
            except OSError:
                pass
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join(30)


class _Sidecar:
    """The port's sidecar (`remote.start`, the reference's defaults unless
    given) on an event loop in a thread of this process, on a free port.
    What its loggers warn of and what its loop reports as unhandled lands
    in `errors`, but for the anomaly watchdog's `verify_regression`
    triggers (the batch service's samples of the card's flushes against
    the reference's thresholds), whose details land in `watchdog` and are
    reported (`watchdog_line`)."""

    def __init__(self, backend, **kw) -> None:
        import asyncio
        import logging
        import threading

        from hotstuff_tpu_torch.crypto import remote

        self.errors: list[str] = []
        self.watchdog: list[str] = []
        errors, watchdog = self.errors, self.watchdog

        class Keep(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if record.name == "hotstuff.tracing" and msg.startswith("anomaly watchdog fired: verify_regression"):
                    watchdog.append(record.args[1])
                else:
                    errors.append(f"{record.name}: {msg}")

        self._handler = Keep(logging.WARNING)
        logging.getLogger("hotstuff").addHandler(self._handler)
        self.loop = asyncio.new_event_loop()
        self.loop.set_exception_handler(lambda loop, ctx: errors.append(f"loop: {ctx.get('exception') or ctx['message']}"))
        self._thread = threading.Thread(target=self.loop.run_forever, name="sidecar", daemon=True)
        self._thread.start()
        start = remote.start(("127.0.0.1", 0), backend, **kw)
        self.server, self.service = asyncio.run_coroutine_threadsafe(start, self.loop).result(60)
        self.port = self.server.sockets[0].getsockname()[1]

    def watchdog_line(self, label: str, card_lanes: int, host_lanes: int) -> str:
        """The process's verify baseline and each of the sidecar's
        `verify_regression` triggers (its per-signature cost against the
        baseline it was held to, in us) beside the lanes the phase verified
        on the card and on the host: a fire over flushes of mixed sizes
        with every lane on the card reads apart from a route change."""
        from hotstuff_tpu_torch.utils import tracing

        base = tracing.WATCHDOG._verify_baseline
        fired = "; ".join(f"{1e6 * d['per_sig_s']:.3f} against {1e6 * d['baseline_s']:.3f}" for d in self.watchdog)
        return (f"{label} watchdog: verify baseline {'none' if base is None else f'{1e6 * base:.3f}'} us a "
                f"signature; verify_regression fired {len(self.watchdog)} times{f' ({fired} us)' if fired else ''}; "
                f"{card_lanes} lanes on the card, {host_lanes} on the host")

    def thread_time(self) -> float:
        """CPU seconds of the sidecar's event-loop thread so far."""
        import asyncio

        async def read():
            return time.thread_time()

        return asyncio.run_coroutine_threadsafe(read(), self.loop).result(60)

    def stop(self) -> None:
        import asyncio
        import logging

        async def shutdown():
            self.server.close()
            tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(60)
        self.loop.close()
        logging.getLogger("hotstuff").removeHandler(self._handler)


class _Timed:
    """Wraps the function `owner.name` (plain or coroutine) so that each
    call adds (start, end, thread CPU seconds, size(args, result)) to the
    records that `take()` returns and clears; `restore()` puts it back.
    Times are time.monotonic, one clock with the load generators. A
    coroutine's CPU seconds are those of every task its thread ran
    meanwhile, so they are not read."""

    def __init__(self, owner, name: str, size) -> None:
        import inspect
        import threading

        self.owner, self.name, self.fn = owner, name, getattr(owner, name)
        self.own = name in vars(owner)
        self.records, self._lock = [], threading.Lock()
        fn = self.fn

        def add(t, c, out, args):
            rec = (t, time.monotonic(), time.thread_time() - c, size(args, out))
            with self._lock:
                self.records.append(rec)

        if inspect.iscoroutinefunction(fn):
            async def timed(*args, **kw):
                t, c = time.monotonic(), time.thread_time()
                out = await fn(*args, **kw)
                add(t, c, out, args)
                return out
        else:
            def timed(*args, **kw):
                t, c = time.monotonic(), time.thread_time()
                out = fn(*args, **kw)
                add(t, c, out, args)
                return out

        setattr(owner, name, timed)

    def take(self) -> list[tuple[float, float, float, int]]:
        with self._lock:
            out, self.records = self.records, []
        return out

    def restore(self) -> None:
        if self.own:
            setattr(self.owner, self.name, self.fn)
        else:
            delattr(self.owner, self.name)


class _GcPauses:
    """The garbage collector's pauses in this process, as (start, end,
    generation) on time.monotonic, until `close()`."""

    def __init__(self) -> None:
        self.pauses, self._start = [], 0.0
        gc.callbacks.append(self._note)

    def _note(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.monotonic()
        else:
            self.pauses.append((self._start, time.monotonic(), info["generation"]))

    def take(self) -> list[tuple[float, float, int]]:
        out, self.pauses = self.pauses, []
        return out

    def close(self) -> None:
        gc.callbacks.remove(self._note)


def _wall(records) -> float:
    return sum(r[1] - r[0] for r in records)


def urgent_timeline(times, submits, calls, parses, gcs, n: int) -> tuple[list[dict], int]:
    """Where each urgent request of `n` lanes spent its round trip, in ms.
    `times` are the client's (send, reply) pairs; `submits`, `calls` and
    `parses` the sidecar's `_Timed` records of `verify_group`, the backend
    call and the parse; `gcs` the collector's pauses. Segments: wait (the
    send to the parse's start: the wire and the loop thread's backlog),
    parse, queue (`verify_group`'s start to the backend call's: the
    scheduler, the dedup scan, the hand-off to a thread), backend (and its
    thread's CPU), resolve (the call's end to `verify_group`'s return),
    reply (to the client's receipt); gc is the collector's pause time
    inside the round trip. Returns the rows and the count of requests
    whose records were not all found."""
    rows, unmatched = [], 0
    for t_send, t_recv in times:
        sub = [r for r in submits if r[3] == n and t_send <= r[0] <= t_recv]
        call = sub and [r for r in calls if r[3] == n and sub[0][0] <= r[0] <= sub[0][1]]
        parse = sub and [r for r in parses if r[3] == n and t_send <= r[0] <= sub[0][0]]
        if len(sub) != 1 or len(call) != 1 or not parse:
            unmatched += 1
            continue
        (sub,), (call,), parse = sub, call, parse[-1]
        gc_s = sum(max(0.0, min(b, t_recv) - max(a, t_send)) for a, b, _ in gcs)
        rows.append({k: v * 1e3 for k, v in dict(
            rtt=t_recv - t_send, wait=parse[0] - t_send, parse=parse[1] - parse[0],
            queue=call[0] - sub[0], backend=call[1] - call[0], backend_cpu=call[2],
            resolve=sub[1] - call[1], reply=t_recv - sub[1], gc=gc_s).items()})
    return rows, unmatched


def phase_sidecar(seed: int, backend, committee_path: dict, direct_rate: float, card: str) -> dict:
    """The sidecar under full-width load (see the module docstring),
    serving `backend`."""
    from hotstuff_tpu_torch.crypto import remote
    from hotstuff_tpu_torch.ops import _build
    from hotstuff_tpu_torch.utils import metrics
    from hotstuff_tpu_torch.utils.metrics import percentile

    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        M, K, S, expected = _sidecar_corpus(seed, pool)
    n_bad = int((~expected).sum())
    print(f"sidecar corpus: {len(M)} distinct triples over {SIDECAR_KEYS} keys (OpenSSL), {n_bad} corrupted "
          f"lanes, in {time.perf_counter() - t0:.1f} s", flush=True)
    QM, QK, QS, qexp = committee_path["qcs"]
    urgent = [(QM[a:a + QUORUM], QK[a:a + QUORUM], QS[a:a + QUORUM], qexp[a:a + QUORUM])
              for a in range(0, SIGNED_QCS * QUORUM, QUORUM)]

    t0 = time.perf_counter()
    remote.warmup_backend(backend)
    backend.register_committee(committee_path["table_keys"], warmup=True)
    sidecar = _Sidecar(backend)
    print(f"sidecar: warmup and {len(committee_path['table_keys'])}-key committee in "
          f"{time.perf_counter() - t0:.1f} s, serving on port {sidecar.port}; {len(gc.get_objects())} "
          f"objects tracked by the collector in this process", flush=True)
    clients = None
    # Where a pass's host time goes: the event-loop thread's parse, dedup
    # scan, verdict caching and reply encoding, the backend calls on the
    # dispatch threads (they overlap), the collector's pauses, and the CPU
    # seconds of the loop thread and of the whole process.
    service = sidecar.service
    timers = dict(
        parse=_Timed(remote, "_parse_request", lambda a, r: len(r[0])),
        reply=_Timed(remote, "_encode_reply", lambda a, r: len(a[0])),
        lookup=_Timed(service, "_lookup", lambda a, r: len(a[0])),
        remember=_Timed(service, "_remember", lambda a, r: len(a[1])),
        submit=_Timed(service, "verify_group", lambda a, r: len(a[0])),
        backend=_Timed(backend, "verify_batch_mask", lambda a, r: len(a[0])),
    )
    gc_pauses = _GcPauses()

    def run_pass(p: int, jobs: list, lanes: int) -> tuple[list, dict, dict]:
        """One pass of `jobs`; fails unless every mask is exact, no client
        fell back and the card verified exactly `lanes`. Returns the
        results, the pass's numbers and the timers' records."""
        for t in timers.values():
            t.take()
        gc_pauses.take()
        dev0, loop0, cpu0 = backend.stats["device_sigs"], sidecar.thread_time(), time.process_time()
        res = clients.run(jobs)
        loop_cpu, cpu = sidecar.thread_time() - loop0, time.process_time() - cpu0
        device = backend.stats["device_sigs"] - dev0
        rec = {k: t.take() for k, t in timers.items()}
        rec["gc"] = gc_pauses.take()
        wall = max(r["t1"] for r in res) - min(r["t0"] for r in res)
        if any(r["bad"] for r in res):
            fail(f"sidecar pass {p}: masks differ from the expected masks on {[r['bad'] for r in res]} lanes")
        if any(r["stats"]["cpu_sigs"] for r in res):
            fail(f"sidecar pass {p}: a client fell back to its CPU: {[r['stats'] for r in res]}")
        if device != lanes:
            fail(f"sidecar pass {p}: the card verified {device} lanes, {lanes} were sent")
        gcs = rec["gc"]
        out = dict(
            device_sigs=device, wall_s=wall, sigs_per_s=device / wall, loop_cpu_s=loop_cpu, process_cpu_s=cpu,
            **{f"{k}_s": _wall(rec[k]) for k in ("parse", "lookup", "remember", "reply", "backend")},
            backend_cpu_s=sum(r[2] for r in rec["backend"]), backend_calls=len(rec["backend"]),
            gc_s=sum(b - a for a, b, _ in gcs), gc_max_s=max((b - a for a, b, _ in gcs), default=0.0),
            gc_full=sum(g == 2 for _, _, g in gcs),
        )
        print(f"sidecar pass {p}: {device} lanes on the card in {wall * 1e3:.1f} ms, {device / wall:.1f} sigs/s; "
              f"loop thread CPU {loop_cpu * 1e3:.1f} ms ({loop_cpu / wall:.1%} of the pass), process CPU "
              f"{cpu / wall:.2f} cores; on the loop thread parse {out['parse_s'] * 1e3:.1f} ms "
              f"({out['parse_s'] / device * 1e6:.2f} us a lane), dedup scan {out['lookup_s'] * 1e3:.1f} ms, "
              f"verdict caching {out['remember_s'] * 1e3:.1f} ms, reply encoding {out['reply_s'] * 1e3:.1f} ms; "
              f"backend calls {out['backend_s'] * 1e3:.1f} ms wall and {out['backend_cpu_s'] * 1e3:.1f} ms CPU "
              f"summed over {out['backend_calls']} calls; collector {out['gc_s'] * 1e3:.1f} ms in {len(gcs)} "
              f"pauses (max {out['gc_max_s'] * 1e3:.1f} ms, {out['gc_full']} full)", flush=True)
        return res, out, rec

    try:
        clients = _Clients(sidecar.port, SIDECAR_CONNECTIONS + 1)
        metrics.reset()
        stats0 = dict(backend.stats)
        _build.reset_launches()
        passes, urgent_rtts, urgent_rows, unmatched = [], [], [], 0
        for p in range(SIDECAR_PASSES):
            reqs = _requests(M, K, S, expected, p * SIDECAR_PASS, (p + 1) * SIDECAR_PASS)
            jobs = [reqs[c::SIDECAR_CONNECTIONS] for c in range(SIDECAR_CONNECTIONS)]
            jobs.append(urgent[p * URGENT_PER_PASS:(p + 1) * URGENT_PER_PASS])
            res, out, rec = run_pass(p, jobs, SIDECAR_PASS + URGENT_PER_PASS * QUORUM)
            rows, missed = urgent_timeline(res[-1]["times"], rec["submit"], rec["backend"], rec["parse"],
                                           rec["gc"], QUORUM)
            urgent_rtts += [b - a for a, b in res[-1]["times"]]
            urgent_rows += [dict(row, pass_=p) for row in rows]
            unmatched += missed
            passes.append(out)
        sched = dict(service.scheduler.stats)
        service_stats = dict(service.stats)
        buckets = metrics.dump()["histograms"]["scheduler.bucket_size"]
        queue = service.lane_stats.summary()

        # The traced pass: bulk load alone under torch.profiler (device
        # activity only), for the card's busy share over the pass's wall.
        import torch
        from torch.profiler import ProfilerActivity, profile

        p = SIDECAR_PASSES
        reqs = _requests(M, K, S, expected, p * SIDECAR_PASS, (p + 1) * SIDECAR_PASS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, traced, _ = run_pass(p, [reqs[c::SIDECAR_CONNECTIONS] for c in range(SIDECAR_CONNECTIONS)] + [[]],
                                    SIDECAR_PASS)
            torch.cuda.synchronize()
        device_us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
                        for e in prof.key_averages())
        traced["device_busy_share"] = device_us / 1e6 / traced["wall_s"] if device_us else "not measured"
        print(f"sidecar traced pass {p}: card busy {traced['device_busy_share']} of the pass "
              f"({device_us / 1e3:.1f} ms of device time)", flush=True)

        launches = _build.launches()
        counters = metrics.dump()["counters"]
        st = backend.stats
        if st["host_sigs"] != stats0["host_sigs"] or st["committee_batches"] != stats0["committee_batches"]:
            fail(f"sidecar lanes on the host or the committee path: {st}")
        if counters["verifier.dedup_hits"]:
            fail(f"distinct triples hit the dedup cache: {counters}")
        if launches["committee_ladder"] or launches["h_digits_idx"] or any(launches[k] == 0 for k in GENERIC_KERNELS):
            fail(f"wire traffic did not launch exactly the generic kernels: {launches}")
        if sched["critical_dispatches"] < SIDECAR_PASSES * URGENT_PER_PASS:
            fail(f"urgent requests did not take the critical lane: {sched}")

        # Replay the traced pass: its valid lanes are all still cached (no
        # valid triple was inserted after them).
        lo = SIDECAR_PASSES * SIDECAR_PASS
        last = _requests(M, K, S, expected, lo, lo + SIDECAR_PASS)
        hits0, dev0 = counters["verifier.dedup_hits"], backend.stats["device_sigs"]
        res = clients.run([last[c::SIDECAR_CONNECTIONS] for c in range(SIDECAR_CONNECTIONS)] + [[]])
        seg = expected[lo:lo + SIDECAR_PASS]
        hits = metrics.dump()["counters"]["verifier.dedup_hits"] - hits0
        device = backend.stats["device_sigs"] - dev0
        if any(r["bad"] or r["stats"]["cpu_sigs"] for r in res):
            fail("sidecar replay: masks differ or a client fell back to its CPU")
        if hits != int(seg.sum()) or device != int((~seg).sum()):
            fail(f"sidecar replay: {hits} dedup hits for {int(seg.sum())} valid lanes, "
                 f"{device} card lanes for {int((~seg).sum())} invalid ones")
        print(f"sidecar replay of pass {SIDECAR_PASSES}: {hits} dedup hits (its valid lanes), "
              f"{device} lanes on the card (its invalid lanes)", flush=True)
        if sidecar.errors:
            fail(f"the sidecar reported: {sidecar.errors[:5]}")
        print(sidecar.watchdog_line("sidecar", backend.stats["device_sigs"] - stats0["device_sigs"],
                                    backend.stats["host_sigs"] - stats0["host_sigs"]), flush=True)
    finally:
        for t in timers.values():
            t.restore()
        gc_pauses.close()
        if clients is not None:
            clients.close()
        sidecar.stop()

    rates = [p["sigs_per_s"] for p in passes]
    # Segments of the urgent requests whose records were all found (an
    # urgent group that shared a flush with another has none of its own).
    worst = max(urgent_rows, key=lambda row: row["rtt"])
    segments = [k for k in worst if k != "pass_"]
    urgent_p50 = {k: percentile([row[k] for row in urgent_rows], 0.5) for k in segments}
    result = dict(
        passes=passes, sigs_per_s_median=statistics.median(rates), sigs_per_s_min=min(rates),
        sigs_per_s_max=max(rates), direct_sigs_per_s=direct_rate, traced=traced,
        urgent_rtt_ms_p50=1e3 * percentile(urgent_rtts, 0.5), urgent_rtt_ms_max=1e3 * max(urgent_rtts),
        urgent_requests=len(urgent_rtts), urgent_p50_ms=urgent_p50, urgent_slowest_ms=worst,
        urgent_unmatched=unmatched, service=service_stats, scheduler=sched,
        bucket_size={k: buckets[k] for k in ("count", "min", "p50", "mean", "max")}, queue_delay=queue,
        launches=launches, card=card,
    )
    print(f"sidecar: {statistics.median(rates):.1f} sigs/s median of {SIDECAR_PASSES} passes "
          f"(min {min(rates):.1f}, max {max(rates):.1f}) over TCP, {SIDECAR_CONNECTIONS} connections of "
          f"{SIDECAR_REQUEST}-item requests; direct TorchBackend (phase 3) {direct_rate:.1f} sigs/s; "
          f"urgent {QUORUM}-vote round trip p50 {result['urgent_rtt_ms_p50']:.3f} ms, max "
          f"{result['urgent_rtt_ms_max']:.3f} ms (request {urgent_rtts.index(max(urgent_rtts))}) over "
          f"{len(urgent_rtts)} requests, {URGENT_PER_PASS} a pass; {card}", flush=True)
    print(f"sidecar urgent round trip in ms over the {len(urgent_rows)} requests with a flush of their own "
          f"({unmatched} without), p50 of each segment: "
          + ", ".join(f"{k} {urgent_p50[k]:.3f}" for k in segments)
          + f"; the slowest request (pass {worst['pass_']}): " + ", ".join(f"{k} {worst[k]:.3f}" for k in segments), flush=True)
    print(f"sidecar service: {json.dumps(dict(service=service_stats, scheduler=sched, bucket_size=result['bucket_size'], queue_delay=queue, launches=launches))}", flush=True)
    return result


# --- phase 7: four reference nodes against the port's sidecar ----------------


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def write_node_configs(run_dir: Path, names: list[str], ports: list[int],
                       parameters: dict | None = None) -> tuple[Path, Path]:
    """The committee and parameters files of a local committee, in the
    format of benchmark/config.py (`LocalCommittee`, `NodeParameters`):
    node i's consensus, mempool and front addresses on ports[i],
    ports[n + i] and ports[2n + i]; `parameters` (default
    LOCAL_NODE_PARAMS)."""
    n = len(names)
    addr = lambda p: f"127.0.0.1:{p}"
    committee = {
        "consensus": {"epoch": 1, "authorities": {
            name: {"stake": 1, "address": addr(ports[i])} for i, name in enumerate(names)}},
        "mempool": {"epoch": 1, "authorities": {
            name: {"front_address": addr(ports[2 * n + i]), "mempool_address": addr(ports[n + i])}
            for i, name in enumerate(names)}},
    }
    paths = run_dir / ".committee.json", run_dir / ".parameters.json"
    for path, obj in zip(paths, (committee, parameters or LOCAL_NODE_PARAMS)):
        path.write_text(json.dumps(obj, indent=2, sort_keys=True))
    return paths


def committed_blocks(log_text: str) -> dict[int, str]:
    """Round -> block digest of every `Committed B<r>(<digest>)` line of a
    node log (consensus/core.py's commit line; the per-payload lines that
    follow it are skipped)."""
    return {int(r): d for r, d in re.findall(r"Committed B(\d+)\(([^)]*)\)\s*$", log_text, re.M)}


def committed_between(log_text: str, start: float, end: float) -> int:
    """How many `Committed B<r>(<digest>)` lines of a node log are stamped
    (UTC, the log's `[YYYY-mm-ddTHH:MM:SS.mmmZ ...` prefix) at or after
    `start` and before `end`, both in seconds since the epoch."""
    return sum(start <= _log_seconds(stamp) < end
               for stamp in re.findall(r"^\[(\S+)Z \S+ \S+\] Committed B\d+\([^)]*\)\s*$", log_text, re.M))


def _log_seconds(stamp: str) -> float:
    """Seconds since the epoch of a node log's UTC stamp
    (`YYYY-mm-ddTHH:MM:SS.mmm`)."""
    return calendar.timegm(time.strptime(stamp[:19], "%Y-%m-%dT%H:%M:%S")) + float("0" + stamp[19:])


def check_commits(logs: dict[str, str]) -> dict[str, dict[int, str]]:
    """Every node committed a block, and where two nodes committed the same
    round, the digests are equal. Returns the commits by node."""
    commits = {name: committed_blocks(text) for name, text in logs.items()}
    empty = [name for name, c in commits.items() if not c]
    if empty:
        fail(f"nodes committed no block: {empty}")
    seen: dict[int, tuple[str, str]] = {}
    for name, c in commits.items():
        for r, d in c.items():
            if r in seen and seen[r][1] != d:
                fail(f"round {r}: {seen[r][0]} committed {seen[r][1]}, {name} committed {d}")
            seen.setdefault(r, (name, d))
    return commits


def _spawn(cmd: list[str], log: Path, cwd: Path, env: dict | None = None):
    with open(log, "w") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=cwd,
                                env=dict(os.environ, PYTHONPATH=str(REPO), **(env or {})), start_new_session=True)


def _await_logs(waits: list, phrase: str, what: str) -> None:
    """Until every (log, process) has `phrase` in its log; fails when a
    process exits first or BOOT_TIMEOUT_S passes."""
    deadline = time.monotonic() + BOOT_TIMEOUT_S
    pending = list(waits)
    while pending:
        if time.monotonic() > deadline:
            fail(f"{what} never ready: {[str(p) for p, _ in pending]}")
        time.sleep(0.25)
        for log, proc in list(pending):
            if phrase in log.read_text(errors="replace"):
                pending.remove((log, proc))
            elif proc.poll() is not None:
                fail(f"{what} exited at start (rc {proc.returncode}); see {log}:\n{log.read_text()[-2000:]}")


def _kill(procs: list) -> None:
    for proc in procs:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
    for proc in procs:
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)


def phase_committee_run(backend, qcs, run_dir: Path) -> dict:
    """Four unchanged reference nodes commit against the port's sidecar
    (see the module docstring). `backend` serves them in this process;
    the CLI (`python -m hotstuff_tpu_torch.crypto.remote`) boots beside
    them on the card and answers one QC."""
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.remote import RemoteBackend
    from hotstuff_tpu_torch.node.config import read_consensus_keys
    from hotstuff_tpu_torch.ops import _build

    n = LOCAL_BENCH["nodes"]
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    py = sys.executable
    t0 = time.perf_counter()
    keygen = [_spawn([py, "-m", "hotstuff_tpu.node.main", "keys", "--filename", f".node-{i}.json"],
                     run_dir / f"keys-{i}.log", run_dir) for i in range(n)]
    if any(p.wait(BOOT_TIMEOUT_S) for p in keygen):
        fail(f"the reference key generation failed; see {run_dir}")
    names = [json.loads((run_dir / f".node-{i}.json").read_text())["name"] for i in range(n)]
    ports = _free_ports(3 * n)
    committee, parameters = write_node_configs(run_dir, names, ports)
    backend.register_committee(read_consensus_keys(str(committee)), warmup=True)
    procs, cli, sidecar = [], None, None
    try:
        cli_log = run_dir / "sidecar-cli.log"
        cli = _spawn([py, "-m", "hotstuff_tpu_torch.crypto.remote", "-vv", "--port", "0",
                      "--committee", str(committee)], cli_log, run_dir)
        sidecar = _Sidecar(backend)
        stats0 = dict(backend.stats)
        _build.reset_launches()
        nodes = []
        for i in range(n):
            log = run_dir / f"node-{i}.log"
            nodes.append((log, _spawn([
                py, "-m", "hotstuff_tpu.node.main", "-vv", "run", "--keys", f".node-{i}.json",
                "--committee", committee.name, "--store", f".db-{i}/log", "--parameters", parameters.name,
                "--crypto", "remote", "--crypto-addr", f"127.0.0.1:{sidecar.port}", "--crypto-crossover", "1",
            ], log, run_dir)))
        procs += [p for _, p in nodes]
        t_nodes = time.monotonic()
        _await_logs(nodes, "successfully booted", "node")
        consensus = [f"127.0.0.1:{p}" for p in ports[:n]]
        clients = []
        for i in range(n):
            log = run_dir / f"client-{i}.log"
            clients.append((log, _spawn([
                py, "-m", "hotstuff_tpu.node.client", "-vv", f"127.0.0.1:{ports[2 * n + i]}",
                "--size", str(LOCAL_BENCH["tx_size"]), "--rate", str(LOCAL_BENCH["rate"] // n),
                "--nodes", *consensus], log, run_dir)))
        procs += [p for _, p in clients]
        _await_logs(clients, "Start sending transactions", "client")
        t_run = time.monotonic()
        print(f"committee run: keys, {n} nodes and {n} clients up in {time.perf_counter() - t0:.1f} s", flush=True)

        # The CLI on the card: boots (warmup and committee included) and
        # answers one QC of votes with the expected mask.
        _await_logs([(cli_log, cli)], "successfully booted", "the sidecar CLI")
        cli_port = int(re.search(r"successfully booted on [\d.]+:(\d+)", cli_log.read_text()).group(1))
        client = RemoteBackend(("127.0.0.1", cli_port), crossover=1)
        QM, QK, QS, qexp = qcs
        mask = client.verify_batch_mask(QM[:QUORUM], [PublicKey(k) for k in QK[:QUORUM]],
                                        [Signature(s) for s in QS[:QUORUM]])
        client.close()
        if mask != qexp[:QUORUM] or client.stats["remote_sigs"] != QUORUM:
            fail(f"the sidecar CLI answered a QC wrongly: {client.stats}")
        print(f"sidecar CLI: booted on the card, one {QUORUM}-vote QC answered with the expected mask", flush=True)

        time.sleep(max(0.0, LOCAL_BENCH["duration"] - (time.monotonic() - t_run)))
        errors = list(sidecar.errors)  # before the kill, which resets connections
        launches = _build.launches()
        device = backend.stats["device_sigs"] - stats0["device_sigs"]
        host = backend.stats["host_sigs"] - stats0["host_sigs"]
        print(sidecar.watchdog_line("committee run's sidecar", device, host), flush=True)
        wall, node_s = time.monotonic() - t_run, time.monotonic() - t_nodes
    finally:
        _kill(procs + ([cli] if cli is not None else []))
        if sidecar is not None:
            sidecar.stop()
        for store in run_dir.glob(".db-*"):
            shutil.rmtree(store, ignore_errors=True)
    logs = {f"node-{i}": (run_dir / f"node-{i}.log").read_text(errors="replace") for i in range(n)}
    for name, text in logs.items():
        for phrase in ("synthetic batch verification failed", "sidecar unreachable"):
            if phrase in text:
                fail(f"{name} logged '{phrase}'; see {run_dir}")
    commits = check_commits(logs)
    if errors:
        fail(f"the sidecar reported: {errors[:5]}")
    if device <= 0 or host:
        fail(f"the sidecar verified {device} lanes on the card and {host} on the host")
    if any(launches[k] == 0 for k in GENERIC_KERNELS) or launches["committee_ladder"] or launches["h_digits_idx"]:
        fail(f"the committee's traffic did not launch exactly the generic kernels: {launches}")
    synthetic = sum(int(x) for text in logs.values()
                    for x in re.findall(r"transaction batch\. Size: (\d+)", text))
    blocks = {name: len(c) for name, c in commits.items()}
    rounds = max(max(c) for c in commits.values())
    result = dict(blocks=blocks, max_round=rounds, commits_per_s=min(blocks.values()) / node_s,
                  synthetic_sigs=synthetic, device_sigs=device, launches=launches, wall_s=wall, node_s=node_s)
    print(f"committee run: {n} reference nodes, --crypto remote --crypto-crossover 1, {wall:.1f} s of client "
          f"traffic, {node_s:.1f} s from the nodes' start: blocks committed {blocks} (digests agree), "
          f"{result['commits_per_s']:.2f} commits/s per node, synthetic workload {synthetic} signatures, "
          f"{device} lanes on the card, launches {launches}", flush=True)
    return result


# --- phase 13: the port's own committee on the card -------------------------

NODE_KERNELS = frozenset(GENERIC_KERNELS) | frozenset(COMMITTEE_KERNELS)


def port_node_cmd(py: str, i: int, committee: str, parameters: str, metrics_out: str,
                  telemetry_port: int | None = None, trace_out: str | None = None) -> list[str]:
    """Node i of the port's committee: `--crypto torch` on the card (the
    default device), every batch of one signature or more on the card; its
    telemetry plane on `telemetry_port` and its flight recorder's dump (and
    the anomaly watchdog's dumps beside it) at `trace_out` when given."""
    cmd = [py, "-m", "hotstuff_tpu_torch.node.main", "-vv", "run", "--keys", f".node-{i}.json",
           "--committee", committee, "--store", f".db-{i}/log", "--parameters", parameters,
           "--crypto", "torch", "--crypto-crossover", "1", "--metrics-out", metrics_out]
    if telemetry_port is not None:
        cmd += ["--telemetry-port", str(telemetry_port)]
    return cmd if trace_out is None else [*cmd, "--trace-out", trace_out]


def port_client_cmd(py: str, front: int, consensus: list[str], n: int) -> list[str]:
    """A client of the port at LOCAL_BENCH's size and its rate's n-th part,
    waiting for every node's consensus address first."""
    return [py, "-m", "hotstuff_tpu_torch.node.client", "-vv", f"127.0.0.1:{front}",
            "--size", str(LOCAL_BENCH["tx_size"]), "--rate", str(LOCAL_BENCH["rate"] // n), "--nodes", *consensus]


def node_dump_lanes(dump: dict) -> dict:
    """A node's lanes from its metrics dump: on the card on the generic and
    the committee route, and on the host."""
    c = dump.get("counters", {})
    device, committee = c.get("crypto.tpu_sigs", 0), c.get("verifier.committee_sigs", 0)
    return {"generic": device - committee, "committee": committee, "host": c.get("crypto.cpu_sigs", 0)}


NODE_TIMINGS = ("consensus.commit_latency_s", "consensus.proposal_to_vote_s", "scheduler.queue_consensus_s",
                "scheduler.queue_mempool_s", "verifier.dispatch_s", "verifier.readback_s")


def node_dump_timings(dump: dict) -> dict:
    """Where a node's time went, from its dump: p50 and p99 in ms of each
    histogram of NODE_TIMINGS, and the card's batches and their mean size."""
    h = dump.get("histograms", {})
    out = {name: (round(1e3 * h[name]["p50"], 3), round(1e3 * h[name]["p99"], 3)) for name in NODE_TIMINGS if name in h}
    size = h.get("crypto.batch_size", {})
    out["card_batches"] = dump.get("counters", {}).get("crypto.tpu_batches", 0)
    out["mean_batch"] = round(size.get("mean", 0.0), 2)
    return out


def node_dump_errors(name: str, dump: dict) -> list[str]:
    """What a node's dump got wrong: no lanes on the card on a route, lanes
    on the host, a kernel of the node's path never launched, or another
    kernel launched."""
    errors = []
    lanes = node_dump_lanes(dump)
    if lanes["generic"] <= 0 or lanes["committee"] <= 0 or lanes["host"]:
        errors.append(f"{name}: lanes {lanes}")
    launches = dump.get("launches")
    if not isinstance(launches, dict) or not launches:
        return errors + [f"{name}: the dump holds no launch counts"]
    idle = sorted(k for k in NODE_KERNELS if not launches.get(k))
    if idle:
        errors.append(f"{name}: {idle} never launched")
    off = sorted(k for k, v in launches.items() if v and k not in NODE_KERNELS)
    if off:
        errors.append(f"{name}: {off} launched off the node's path: {launches}")
    return errors


SCRAPE_AT_S = (8.0, 18.0)  # phase 13's scrapes of each node, seconds into the client traffic
# Verifier batches a node may have in flight when SIGTERM writes its dump:
# counted into verifier.batches, their verifier.e2e_s sample not yet
# recorded (the scheduler's bulk slots and a few critical dispatches).
NODE_IN_FLIGHT = 8


def node_scrape_errors(label: str, scrapes: list[dict]) -> list[str]:
    """What a node's scrapes during the traffic got wrong: a scrape that is
    not the node's telemetry dump, a snapshot ring that did not grow
    between the first and the last, no events on the consensus or the
    mempool lane, or no verifier batch in the snapshots (each records one
    `verifier.e2e_s` sample, the events of the verify.e2e SLO)."""
    errors = [e for d in scrapes for e in telemetry_errors(d, label)]
    if errors:
        return errors
    first, last = scrapes[0], scrapes[-1]
    if len(last["snapshots"]) <= len(first["snapshots"]):
        errors.append(f"{label}: the snapshot ring did not grow ({len(first['snapshots'])} -> "
                      f"{len(last['snapshots'])})")
    lanes = last.get("lanes") or {}
    idle = [lane for lane in ("consensus", "mempool") if lanes.get(lane, {}).get("count", 0) <= 0]
    if idle:
        errors.append(f"{label}: no events on the {idle} lanes: {lanes}")
    if not scrape_batches(last):
        errors.append(f"{label}: no verifier batch in the snapshots, so the verify.e2e SLO saw no event")
    return errors


def scrape_batches(dump: dict) -> int:
    """Verifier batches over a dump's snapshot ring: the events its
    verify.e2e SLO read."""
    return sum(snap.get("counters", {}).get("verifier.batches", 0) for snap in dump.get("snapshots") or ())


def committed_txs(logs: dict[str, str], tx_size: int, window: tuple[float, float] | None = None) -> dict[str, int]:
    """Transactions each node committed: the bytes of the distinct payloads
    its `Committed B<r>(...) -> <payload>` lines name, over `tx_size`, as the
    reference's log parser counts them (`benchmark/logs.py`). A payload's
    size is its author's `Payload <digest> contains <n> B` line, in any
    node's log. With `window` (start, end: seconds since the epoch), only
    the lines stamped at or after start and before end count."""
    sizes = {d: int(n) for text in logs.values()
             for d, n in re.findall(r"Payload (\S+) contains (\d+) B$", text, re.M)}
    out = {}
    for name, text in logs.items():
        if window is None:
            committed = set(re.findall(r"Committed B\d+\([^)]*\) -> (\S+)$", text, re.M))
        else:
            committed = {d for stamp, d in re.findall(r"^\[(\S+)Z \S+ \S+\] Committed B\d+\([^)]*\) -> (\S+)$",
                                                      text, re.M)
                         if window[0] <= _log_seconds(stamp) < window[1]}
        out[name] = sum(sizes.get(d, 0) for d in committed) // tx_size
    return out


WATCHDOG_BASELINE_RE = re.compile(r"watchdog verify baseline: ([\d.]+) us a signature")


def node_watchdog(run_dir: Path, trace_out: str, log_text: str) -> dict:
    """What a traced node's anomaly watchdog did, from its log and its run
    directory: the verify baseline it took (us a signature, None if it took
    none), its `verify_regression` triggers and every trigger by reason,
    and the auto-dump files written beside `trace_out`."""
    base = WATCHDOG_BASELINE_RE.findall(log_text)
    fired = re.findall(r"anomaly watchdog fired: (\w+)", log_text)
    return dict(baseline_us=float(base[0]) if base else None, verify_regression=fired.count("verify_regression"),
                triggers={r: fired.count(r) for r in sorted(set(fired))},
                dumps=sorted(p.name for p in run_dir.glob(f"{trace_out}.watchdog-*.json")))


# Phase 13's tracing: `dump` runs each node with `--trace-out` (the
# phase's own), `on` with the recorder and the watchdog on but no dump
# (`HOTSTUFF_TRACE` unset, as before the watchdog's feed), `off` with
# `HOTSTUFF_TRACE=0`. `--tracing-ab` runs the three in turns.
TRACING_MODES = ("dump", "on", "off")


def phase_port_committee(run_dir: Path, tracing: str = "dump") -> dict:
    """Phase 13: four of the port's nodes commit on the card (see the
    module docstring), traced as `tracing` (TRACING_MODES) says."""
    from hotstuff_tpu_torch.store import store as port_store
    from hotstuff_tpu_torch.utils import telemetry

    n = LOCAL_BENCH["nodes"]
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    py = sys.executable
    t0 = time.perf_counter()
    port_store._load_library()  # the store engine, built once before four nodes open it
    keygen = [_spawn([py, "-m", "hotstuff_tpu_torch.node.main", "keys", "--filename", f".node-{i}.json"],
                     run_dir / f"keys-{i}.log", run_dir) for i in range(n)]
    if any(p.wait(BOOT_TIMEOUT_S) for p in keygen):
        fail(f"the port's key generation failed; see {run_dir}")
    names = [json.loads((run_dir / f".node-{i}.json").read_text())["name"] for i in range(n)]
    ports = _free_ports(4 * n)
    committee, parameters = write_node_configs(run_dir, names, ports)
    telemetry_ports = ports[3 * n:]
    dumps = [run_dir / f"metrics-{i}.json" for i in range(n)]
    traces = [f"trace-{i}.json" if tracing == "dump" else None for i in range(n)]
    env = {"HOTSTUFF_TRACE": "0"} if tracing == "off" else None
    labels = [f".node-{i}" for i in range(n)]  # the keys-file stems
    scrapes: dict[str, list[dict]] = {label: [] for label in labels}
    procs = []
    try:
        nodes = []
        for i in range(n):
            log = run_dir / f"node-{i}.log"
            cmd = port_node_cmd(py, i, committee.name, parameters.name, dumps[i].name, telemetry_ports[i],
                                traces[i])
            nodes.append((log, _spawn(cmd, log, run_dir, env)))
        procs += [p for _, p in nodes]
        t_nodes = time.monotonic()
        _await_logs(nodes, "successfully booted", "port node")
        boot_s = time.monotonic() - t_nodes
        consensus = [f"127.0.0.1:{p}" for p in ports[:n]]
        clients = []
        for i in range(n):
            log = run_dir / f"client-{i}.log"
            clients.append((log, _spawn(port_client_cmd(py, ports[2 * n + i], consensus, n), log, run_dir)))
        procs += [p for _, p in clients]
        _await_logs(clients, "Start sending transactions", "client")
        t_run, t_run_utc = time.monotonic(), time.time()
        print(f"port committee: keys, {n} nodes (booted in {boot_s:.1f} s) and {n} clients up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for at in SCRAPE_AT_S:  # each node's telemetry endpoint, twice during the traffic
            time.sleep(max(0.0, t_run + at - time.monotonic()))
            for label, port in zip(labels, telemetry_ports):
                scrapes[label].append(telemetry.scrape_sync(("127.0.0.1", port)))
        time.sleep(max(0.0, t_run + LOCAL_BENCH["duration"] - time.monotonic()))
        wall, node_s = time.monotonic() - t_run, time.monotonic() - t_nodes
    finally:
        _kill(procs)  # SIGTERM: each node writes its dump
        for store in run_dir.glob(".db-*"):
            shutil.rmtree(store, ignore_errors=True)
    logs = {f"node-{i}": (run_dir / f"node-{i}.log").read_text(errors="replace") for i in range(n)}
    for name, text in logs.items():
        if "synthetic batch verification failed" in text:
            fail(f"{name} logged a synthetic verification failure; see {run_dir}")
    commits = check_commits(logs)
    errors, lanes, launches, timings, e2e, watchdogs = [], {}, {}, {}, {}, {}
    for i, path in enumerate(dumps):
        name = f"node-{i}"
        try:
            dump = json.loads(path.read_text())
            trace = json.loads((run_dir / traces[i]).read_text()) if traces[i] else None
        except (OSError, json.JSONDecodeError) as e:
            fail(f"{name} left no metrics or trace dump ({e!r}); see {run_dir}")
        if trace is not None and (trace.get("node") != labels[i] or not trace.get("recorded")):
            errors.append(f"{name}: its trace dump is labelled {trace.get('node')!r} with "
                          f"{trace.get('recorded')} events")
        if tracing != "off":
            watchdogs[name] = node_watchdog(run_dir, traces[i] or f"trace-{i}.json", logs[name])
            if watchdogs[name]["baseline_us"] is None:
                errors.append(f"{name}: its anomaly watchdog took no verify baseline from the card's flushes")
        errors += node_dump_errors(name, dump)
        errors += node_scrape_errors(labels[i], scrapes[labels[i]])
        lanes[name], launches[name] = node_dump_lanes(dump), dump.get("launches", {})
        timings[name] = node_dump_timings(dump)
        hist = dump.get("histograms", {}).get("verifier.e2e_s", {})
        e2e[name] = (hist.get("count", 0), round(1e3 * hist.get("p50", 0.0), 3), round(1e3 * hist.get("p99", 0.0), 3))
        batches = dump.get("counters", {}).get("verifier.batches", 0)
        if not e2e[name][0] or not 0 <= batches - e2e[name][0] <= NODE_IN_FLIGHT:
            errors.append(f"{name}: verifier.e2e_s holds {e2e[name][0]} samples for {batches} verifier batches")
    if errors:
        fail(f"the port's committee: {errors}")
    synthetic = {name: sum(int(x) for x in re.findall(r"transaction batch\. Size: (\d+)", text))
                 for name, text in logs.items()}
    blocks = {name: len(c) for name, c in commits.items()}
    in_window = {name: committed_between(text, t_run_utc, t_run_utc + wall) for name, text in logs.items()}
    rounds = max(max(c) for c in commits.values())
    txs = committed_txs(logs, LOCAL_BENCH["tx_size"])
    result = dict(blocks=blocks, blocks_in_traffic=in_window, max_round=rounds,
                  commits_per_s=min(in_window.values()) / wall, committed_txs=txs, tx_per_s=min(txs.values()) / wall,
                  synthetic_sigs=synthetic, lanes=lanes, launches=launches, timings=timings, wall_s=wall,
                  node_s=node_s, boot_s=boot_s, watchdogs=watchdogs)
    flags = {"dump": " --trace-out", "on": "", "off": ", HOTSTUFF_TRACE=0"}[tracing]
    print(f"port committee: {n} port nodes, --crypto torch --crypto-crossover 1{flags}, booted in "
          f"{boot_s:.1f} s, "
          f"{wall:.1f} s of client traffic: blocks committed {blocks} in all (digests agree), "
          f"{in_window} within the traffic, round {rounds}, "
          f"{result['commits_per_s']:.2f} commits/s per node over the traffic (the slowest node's); "
          f"transactions committed {txs}, "
          f"{result['tx_per_s']:.1f} tx/s over the client traffic (the slowest node's); synthetic workload "
          f"{synthetic} signatures", flush=True)
    for name in logs:
        print(f"port committee {name}: lanes {lanes[name]}, launches "
              f"{ {k: v for k, v in launches[name].items() if v} }, p50 / p99 ms and card batches "
              f"{timings[name]}", flush=True)
    for i, label in enumerate(labels):
        last = scrapes[label][-1]
        print(f"port committee node-{i} telemetry ({label}): snapshots "
              f"{[len(d['snapshots']) for d in scrapes[label]]} at {list(SCRAPE_AT_S)} s, lanes "
              f"{ {k: v['count'] for k, v in last['lanes'].items()} }, verifier batches in the ring "
              f"{scrape_batches(last)}, active alerts {last['active_alerts']}, alerts fired "
              f"{[a['slo'] for a in last['alerts'] if a['event'] == 'fired']}; verifier.e2e_s (the "
              f"node's run) samples, p50 / p99 ms {e2e[f'node-{i}']}", flush=True)
    for name, w in watchdogs.items():
        print(f"port committee {name} watchdog: verify baseline {w['baseline_us']} us a signature, "
              f"verify_regression triggers {w['verify_regression']} (all triggers {w['triggers']}), "
              f"auto-dump files {len(w['dumps'])} {w['dumps']}", flush=True)
    print(f"port committee with tracing {tracing}: {result['tx_per_s']:.1f} tx/s and "
          f"{result['commits_per_s']:.2f} blocks a second a node (the slowest node's)", flush=True)
    result.update(scrapes=scrapes, e2e=e2e)
    return result


# --- phase 15: the client ingress and commit proofs on the port's nodes ------

# Phase 13's parameters (benchmark/fabfile.py:22-43) with the client plane on.
INGRESS_NODE_PARAMS = {**LOCAL_NODE_PARAMS, "mempool": {**LOCAL_NODE_PARAMS["mempool"], "ingress_enabled": True}}
INGRESS_PORT_OFFSET, PROOFS_PORT_OFFSET = 1_000, 2_000  # the mempool parameters' defaults
# The two legs of `python -m hotstuff_tpu_torch.loadgen` against node 0's
# ingress port: the reference bench's ingress default with proofs, and the
# bench's 5,000 tx/s leg split over four generator processes. Both: a flash
# curve (5x the rate in the middle third) for 10 s, 8 clients, 512 B bodies
# (the committee's tx_size). Each leg's seeds give it clients of its own
# (leg A's transactions replayed in leg B would answer `replay`).
INGRESS_LEGS = {"A": {"rate": 100, "procs": 1, "proofs": True, "seed": 0},
                "B": {"rate": 5_000, "procs": 4, "proofs": False, "seed": 100}}
INGRESS_DURATION_S = 10
INGRESS_SETTLE_S = 2  # after each leg, for what it admitted last to commit
LOADGEN_TIMEOUT_S = 120
LOADGEN_GRACE_S = 5.0  # OpenLoopLoadGen.run's wait for late answers after the curve
# The generic kernels every ingress batch of node 0 must launch.
INGRESS_KERNELS = ("h_digits", "decompress_table", "ladder", "compress_eq")


def free_ports_with_offsets(n: int, offsets=(INGRESS_PORT_OFFSET, PROOFS_PORT_OFFSET), avoid=()) -> list[int]:
    """n distinct free ports p, none in `avoid`, each with p + every offset
    free too and no p + offset another's p: a node's front port and its
    ingress and proof ports."""
    taken = set(avoid)
    out: list[int] = []
    while len(out) < n:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        group = {p} | {p + o for o in offsets}
        if max(group) > 65535 or group & taken:
            continue
        try:
            for o in offsets:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p + o))
        except OSError:
            continue
        out.append(p)
        taken |= group
    return out


def loadgen_cmd(py: str, ingress_port: int, leg: str, json_out: str, proofs_out: str | None = None) -> list[str]:
    """`python -m hotstuff_tpu_torch.loadgen` for one leg of INGRESS_LEGS
    against 127.0.0.1:`ingress_port`."""
    spec = INGRESS_LEGS[leg]
    cmd = [py, "-m", "hotstuff_tpu_torch.loadgen", "--target", f"127.0.0.1:{ingress_port}", "--curve", "flash",
           "--seed", str(spec["seed"]),
           "--rate", str(spec["rate"]), "--duration", str(INGRESS_DURATION_S), "--clients", "8",
           "--tx-bytes", str(LOCAL_BENCH["tx_size"]), "--procs", str(spec["procs"]), "--json-out", json_out, "-v"]
    if spec["proofs"]:
        cmd.append("--proofs")
        if proofs_out:
            cmd += ["--proofs-out", proofs_out]
    return cmd


def loadgen_errors(leg: str, rc: int, summary: dict) -> list[str]:
    """What a leg's run got wrong: an exit code other than 0, unresolved
    submissions or transport errors, offered != accepted + shed + rejected,
    a rejected signature (every generated one is valid), and with proofs
    any tracked transaction not served and verified."""
    errors = []
    if rc != 0:
        errors.append(f"leg {leg}: loadgen exited {rc}")
    if summary.get("unresolved") or summary.get("errors"):
        errors.append(f"leg {leg}: {summary.get('unresolved')} unresolved, {summary.get('errors')} errors")
    rejected = summary.get("bad_signature", 0) + summary.get("replay", 0) + summary.get("malformed", 0)
    if summary.get("offered") != summary.get("accepted", 0) + summary.get("shed", 0) + rejected:
        errors.append(f"leg {leg}: offered {summary.get('offered')} != accepted {summary.get('accepted')} + shed "
                      f"{summary.get('shed')} + rejected {rejected}")
    if summary.get("bad_signature"):
        errors.append(f"leg {leg}: {summary['bad_signature']} valid signatures answered bad_signature")
    if not summary.get("accepted"):
        errors.append(f"leg {leg}: nothing accepted")
    if INGRESS_LEGS[leg]["proofs"]:
        p = summary.get("proofs") or {}
        if not (p.get("tracked") == p.get("served") == p.get("verified_ok") == summary.get("accepted")) \
                or p.get("verify_failed"):
            errors.append(f"leg {leg}: proofs {p} for {summary.get('accepted')} accepted transactions")
    return errors


def ingress_dump_errors(name: str, dump: dict, ingress_node: bool) -> list[str]:
    """What an ingress node's dump got wrong beyond `node_dump_errors`: a
    rejected client signature on any node, a certificate that did not
    certify its committed block (the proof registry's mismatch), and on
    the node that took the traffic no verified client signature or a
    generic kernel of its batches never launched."""
    c = dump.get("counters", {})
    errors = []
    if c.get("ingress.rejected_sigs", 0):
        errors.append(f"{name}: ingress.rejected_sigs {c['ingress.rejected_sigs']}")
    if c.get("proofs.cert_mismatch", 0):
        errors.append(f"{name}: proofs.cert_mismatch {c['proofs.cert_mismatch']}")
    if ingress_node:
        if c.get("ingress.verified_sigs", 0) <= 0:
            errors.append(f"{name}: no client signature verified")
        idle = [k for k in INGRESS_KERNELS if not (dump.get("launches") or {}).get(k)]
        if idle:
            errors.append(f"{name}: {idle} never launched")
    return errors


def certificate_verdicts(lines: list[str], committee, device: str = "cuda") -> dict:
    """Each distinct certificate a leg received (the loadgen's
    `--proofs-out` lines), checked fully with `CommitProof.verify(committee)`
    under a `TorchBackend` on `device` (the card) and under the host route
    (OpenSSL),
    and two tampered copies of the first (a flipped payload digest, a
    flipped bit of a vote's signature). Returns the verdicts ("ok" or the
    exception's class name) of each route."""
    import dataclasses

    from hotstuff_tpu_torch.crypto import Digest, Signature
    from hotstuff_tpu_torch.crypto.backend import CpuBackend, set_backend
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.consensus.messages import QC
    from hotstuff_tpu_torch.proofs import CommitProof
    from hotstuff_tpu_torch.utils.serde import Reader

    proofs = [CommitProof.decode(Reader(bytes.fromhex(json.loads(line)["proof"]))) for line in lines]
    if not proofs:
        fail("phase 15: leg A wrote no certificate")
    first = proofs[0]
    flipped = Digest(bytes([first.payload[0].data[0] ^ 1]) + first.payload[0].data[1:])
    (pk0, sig0), *rest = first.cert.votes
    tampered = [dataclasses.replace(first, payload=(flipped, *first.payload[1:])),
                dataclasses.replace(first, cert=QC(first.cert.hash, first.cert.round,
                                                   ((pk0, Signature(bytes([sig0.data[0] ^ 1]) + sig0.data[1:])),
                                                    *rest)))]
    out = {}
    for route, backend in (("card", TorchBackend(device=device, crossover=1)), ("host", CpuBackend())):
        prev = set_backend(backend)
        try:
            verdicts = []
            for proof in proofs + tampered:
                try:
                    proof.verify(committee)
                    verdicts.append("ok")
                except Exception as e:  # the verdict is the exception's kind
                    verdicts.append(type(e).__name__)
        finally:
            set_backend(prev)
        out[route] = {"certificates": verdicts[:len(proofs)], "tampered": verdicts[len(proofs):]}
    return out


def phase_port_ingress(run_dir: Path, device: str = "cuda") -> dict:
    """Phase 15: four port nodes with the client plane on, two loadgen legs
    against node 0's ingress port, leg A's certificates checked on the card
    and on the host (see the module docstring)."""
    from hotstuff_tpu_torch.node.config import Committee as NodeCommittee
    from hotstuff_tpu_torch.node.config import Secret
    from hotstuff_tpu_torch.store import store as port_store

    n = LOCAL_BENCH["nodes"]
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    py = sys.executable
    t0 = time.perf_counter()
    port_store._load_library()
    names = []
    for i in range(n):
        Secret.new().write(str(run_dir / f".node-{i}.json"))
        names.append(json.loads((run_dir / f".node-{i}.json").read_text())["name"])
    others = _free_ports(2 * n)
    fronts = free_ports_with_offsets(n, avoid=others)
    committee_path, parameters = run_dir / ".committee.json", run_dir / ".parameters.json"
    write_node_configs(run_dir, names, others + fronts, INGRESS_NODE_PARAMS)
    dumps = [run_dir / f"metrics-{i}.json" for i in range(n)]
    ingress_port = fronts[0] + INGRESS_PORT_OFFSET
    legs, windows, errors = {}, {}, []
    procs = []
    try:
        nodes = []
        for i in range(n):
            log = run_dir / f"node-{i}.log"
            cmd = port_node_cmd(py, i, committee_path.name, parameters.name, dumps[i].name)
            nodes.append((log, _spawn(cmd, log, run_dir)))
        procs += [p for _, p in nodes]
        t_nodes = time.monotonic()
        _await_logs(nodes, "successfully booted", "port node")
        _await_logs(nodes[:1], "Proof server listening", "node 0's proof port")
        boot_s = time.monotonic() - t_nodes
        print(f"port ingress: {n} nodes booted in {boot_s:.1f} s ({time.perf_counter() - t0:.1f} s with keys); "
              f"ingress on 127.0.0.1:{ingress_port}, proofs on 127.0.0.1:{fronts[0] + PROOFS_PORT_OFFSET}",
              flush=True)
        for leg in INGRESS_LEGS:
            out = run_dir / f"leg-{leg}.json"
            proofs_out = run_dir / f"proofs-{leg}.jsonl"
            log = run_dir / f"loadgen-{leg}.log"
            t_leg = time.time()
            gen = _spawn(loadgen_cmd(py, ingress_port, leg, out.name, proofs_out.name), log, run_dir)
            procs.append(gen)
            try:
                rc = gen.wait(LOADGEN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"phase 15: leg {leg}'s loadgen still running after {LOADGEN_TIMEOUT_S} s; see {log}")
            time.sleep(INGRESS_SETTLE_S)
            t_end = time.time()
            try:
                legs[leg] = json.loads(out.read_text())
            except (OSError, json.JSONDecodeError) as e:
                fail(f"phase 15: leg {leg} wrote no summary (rc {rc}, {e!r}); see {log}:\n{log.read_text()[-2000:]}")
            windows[leg] = (legs[leg].get("curve_t0_unix", t_leg), t_end)
            errors += loadgen_errors(leg, rc, legs[leg])
        node_s = time.monotonic() - t_nodes
    finally:
        _kill(procs)  # SIGTERM: each node writes its dump
        for store in run_dir.glob(".db-*"):
            shutil.rmtree(store, ignore_errors=True)
    logs = {f"node-{i}": (run_dir / f"node-{i}.log").read_text(errors="replace") for i in range(n)}
    for name, text in logs.items():
        if "synthetic batch verification failed" in text or "ingress verification dispatch failed" in text:
            fail(f"{name} logged a failed verification; see {run_dir}")
    commits = check_commits(logs)
    lanes, launches, node_ingress = {}, {}, {}
    for i, path in enumerate(dumps):
        name = f"node-{i}"
        try:
            dump = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            fail(f"{name} left no metrics dump ({e!r}); see {run_dir}")
        errors += node_dump_errors(name, dump) + ingress_dump_errors(name, dump, i == 0)
        lanes[name], launches[name] = node_dump_lanes(dump), dump.get("launches", {})
        c = dump.get("counters", {})
        node_ingress[name] = {k: c.get(k, 0) for k in ("ingress.received", "ingress.verified_sigs",
                                                       "ingress.rejected_sigs", "ingress.forwarded",
                                                       "proofs.indexed", "proofs.resolved", "proofs.served",
                                                       "proofs.subs_shed", "proofs.cert_mismatch")}
    if errors:
        fail(f"phase 15: {errors}")
    lines = (run_dir / "proofs-A.jsonl").read_text().splitlines()
    verdicts = certificate_verdicts(lines, NodeCommittee.read(str(committee_path)).consensus, device)
    card, host = verdicts["card"], verdicts["host"]
    if card != host:
        fail(f"phase 15: the card's verdicts {card} differ from the host's {host}")
    if set(card["certificates"]) != {"ok"} or "ok" in card["tampered"]:
        fail(f"phase 15: certificate verdicts {card}")
    committed = {leg: committed_txs(logs, LOCAL_BENCH["tx_size"], windows[leg]) for leg in INGRESS_LEGS}
    for leg, s in legs.items():
        p = s.get("proofs") or {}
        lat = s.get("latency_ms", {})
        window_s = windows[leg][1] - windows[leg][0]
        tx_s = min(committed[leg].values()) / window_s
        s["committed_tx_per_s"], s["window_s"] = tx_s, window_s
        print(f"port ingress leg {leg} (flash, {INGRESS_LEGS[leg]['rate']} tx/s x5 in the middle third, "
              f"{INGRESS_DURATION_S} s, {INGRESS_LEGS[leg]['procs']} generator process(es)): offered {s['offered']}, "
              f"accepted {s['accepted']}, shed {s['shed']}, rejected "
              f"{s['bad_signature'] + s['replay'] + s['malformed']}; committed {committed[leg]} transactions from "
              f"the curve's start to {INGRESS_SETTLE_S} s after the loadgen's exit, {tx_s:.1f} tx/s over that "
              f"{window_s:.2f} s window (the slowest node's); client p50 / p99 {lat.get('p50')} / "
              f"{lat.get('p99')} ms; last answer "
              f"{s['answer_tail_s']} s after the curve's end, {LOADGEN_GRACE_S - s['answer_tail_s']:.3f} s inside "
              f"the generator's {LOADGEN_GRACE_S} s grace"
              + (f"; proofs tracked {p['tracked']}, served {p['served']}, verified {p['verified_ok']} "
                 f"({p['verified']}), retries {p['retries']}, p50 / p99 {p['latency_ms']['p50']} / "
                 f"{p['latency_ms']['p99']} ms, proof_bytes_max {p['proof_bytes_max']}, "
                 f"{p['certificates']} certificates" if p else ""), flush=True)
    print(f"port ingress certificates: {len(lines)} distinct certificates of leg A verified in full on the card "
          f"and on the host (OpenSSL), verdicts equal; tampered (payload digest, vote signature): card "
          f"{card['tampered']}, host {host['tampered']}", flush=True)
    for name in logs:
        print(f"port ingress {name}: lanes {lanes[name]}, launches "
              f"{ {k: v for k, v in launches[name].items() if v} }, {node_ingress[name]}", flush=True)
    rounds = max(max(c) for c in commits.values())
    print(f"port ingress: every node committed (digests agree), round {rounds}; nodes ran {node_s:.1f} s; "
          f"phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(legs=legs, committed=committed, lanes=lanes, launches=launches, node_ingress=node_ingress,
                verdicts=verdicts, boot_s=boot_s, node_s=node_s)


# --- phase 16: the in-process testbed (node.main deploy) on the card ---------

DEPLOY_NODES = 4
DEPLOY_BASES = (7000, 7100, 7200)  # the reference testbed's consensus, mempool and front ports
DEPLOY_TRAFFIC_S = 15
DEPLOY_KERNELS = ("h_digits", "decompress_table", "ladder", "compress_eq")  # deploy registers no committee
DEPLOY_MIN_BUCKET, DEPLOY_CHUNK = 128, 4096  # TorchBackend's defaults, which deploy keeps


def deploy_ports_taken(n: int = DEPLOY_NODES, bases=DEPLOY_BASES) -> list[int]:
    """The testbed's ports (base + i for each base, i < n) that something
    on 127.0.0.1 already holds: each is tried with a bind, never moved."""
    taken = []
    for port in (b + i for b in bases for i in range(n)):
        sock = socket.socket()
        try:
            sock.bind(("127.0.0.1", port))
        except OSError:
            taken.append(port)
        finally:
            sock.close()
    return taken


def deploy_commit_counts(log_text: str) -> dict[int, dict[str, int]]:
    """Round -> {digest: how many of the process's nodes committed it}, from
    the `Committed B<r>(<digest>)` lines of one deploy log (every node of
    the testbed logs into it)."""
    out: dict[int, dict[str, int]] = {}
    for r, d in re.findall(r"Committed B(\d+)\(([^)]*)\)\s*$", log_text, re.M):
        by_digest = out.setdefault(int(r), {})
        by_digest[d] = by_digest.get(d, 0) + 1
    return out


def deploy_commit_errors(counts: dict[int, dict[str, int]], nodes: int = DEPLOY_NODES) -> list[str]:
    """What a deploy's commits got wrong: no round committed by every node,
    two digests for one round, a digest committed more than `nodes` times,
    or a round below the newest that every node committed which some node
    did not commit (only the rounds past it, cut by SIGTERM, may be
    short)."""
    errors = [f"round {r}: digests {sorted(by)}" for r, by in sorted(counts.items()) if len(by) > 1]
    errors += [f"round {r}: {d} committed {c} times by {nodes} nodes"
               for r, by in sorted(counts.items()) for d, c in by.items() if c > nodes]
    full = [r for r, by in counts.items() if len(by) == 1 and sum(by.values()) == nodes]
    if not full:
        return errors + [f"no round committed by all {nodes} nodes"]
    short = sorted(r for r, by in counts.items() if r < max(full) and sum(by.values()) != nodes)
    if short:
        errors.append(f"rounds {short} are not committed by all {nodes} nodes, though round {max(full)} is")
    return errors


def deploy_widths(max_batch: int, min_bucket: int = DEPLOY_MIN_BUCKET, chunk: int = DEPLOY_CHUNK) -> list[int]:
    """Every lane width the generic kernels can have taken in a run whose
    largest verifier batch held `max_batch` signatures: the verifier pads a
    chunk of n lanes to the power of two from `min_bucket` up, and splits
    batches at `chunk`."""
    widths, w = [], min_bucket
    while True:
        widths.append(w)
        if w >= min(max(max_batch, 1), chunk):
            return widths
        w *= 2


def deploy_launches(dump: dict) -> dict[str, int]:
    """The kernel launch counts of a deploy's metrics dump (its run, after
    the warm-up)."""
    launches = dump.get("launches")
    return dict(launches) if isinstance(launches, dict) else {}


def deploy_dump_errors(dump: dict) -> list[str]:
    """What a deploy's dump got wrong: no lane on the card, lanes on the
    host, a kernel of DEPLOY_KERNELS never launched, another launched, or a
    batch wider than phase 2's widths hold against the plain versions."""
    errors = []
    lanes = node_dump_lanes(dump)
    if lanes["generic"] <= 0 or lanes["committee"] or lanes["host"]:
        errors.append(f"lanes {lanes} (want generic > 0, committee 0, host 0)")
    launches = deploy_launches(dump)
    if not launches:
        return errors + ["the dump holds no launch counts"]
    idle = sorted(k for k in DEPLOY_KERNELS if not launches.get(k))
    if idle:
        errors.append(f"{idle} never launched")
    off = sorted(k for k, v in launches.items() if v and k not in DEPLOY_KERNELS)
    if off:
        errors.append(f"{off} launched off deploy's path: {launches}")
    max_batch = int(dump.get("histograms", {}).get("verifier.batch_size", {}).get("max", 0))
    unheld = sorted(set(deploy_widths(max_batch)) - set(_widths(NODE_BUCKETS)))
    if unheld:
        errors.append(f"widths {unheld} (largest batch {max_batch}) are not among phase 2's {_widths(NODE_BUCKETS)}")
    return errors


def deploy_cmd(py: str, metrics_out: str) -> list[str]:
    """`node.main deploy` as phase 16 runs it: four nodes on the card's
    shared `TorchBackend`, every batch of one signature or more on the
    card."""
    return [py, "-m", "hotstuff_tpu_torch.node.main", "-vv", "deploy", "--nodes", str(DEPLOY_NODES),
            "--crypto-crossover", "1", "--metrics-out", metrics_out]


def phase_port_deploy(run_dir: Path) -> dict:
    """Phase 16: the port's in-process testbed on the card (see the module
    docstring)."""
    n = DEPLOY_NODES
    taken = deploy_ports_taken(n)
    if taken:
        fail(f"deploy's ports are taken: {taken} (the testbed keeps the reference's 7000/7100/7200 + i)")
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    py = sys.executable
    t0 = time.perf_counter()
    log, dump_path = run_dir / "deploy.log", run_dir / "metrics.json"
    consensus = [f"127.0.0.1:{DEPLOY_BASES[0] + i}" for i in range(n)]
    procs = []
    try:
        procs.append(_spawn(deploy_cmd(py, dump_path.name), log, run_dir))
        clients = []
        for i in range(n):
            clog = run_dir / f"client-{i}.log"
            clients.append((clog, _spawn(port_client_cmd(py, DEPLOY_BASES[2] + i, consensus, n), clog, run_dir)))
        procs += [p for _, p in clients]
        _await_logs(clients, "Start sending transactions", "client")
        if procs[0].poll() is not None:
            fail(f"deploy exited (rc {procs[0].returncode}); see {log}:\n{log.read_text()[-2000:]}")
        t_run, t_run_utc = time.monotonic(), time.time()
        up_s = time.perf_counter() - t0
        time.sleep(DEPLOY_TRAFFIC_S)
        wall = time.monotonic() - t_run
    finally:
        _kill(procs)  # SIGTERM: deploy writes its dump
        for store in run_dir.glob(".db_*"):
            shutil.rmtree(store, ignore_errors=True)
    text = log.read_text(errors="replace")
    try:
        dump = json.loads(dump_path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        fail(f"deploy left no metrics dump ({e!r}); see {run_dir}")
    counts = deploy_commit_counts(text)
    errors = deploy_commit_errors(counts, n) + deploy_dump_errors(dump)
    if errors:
        fail(f"deploy: {errors}; see {run_dir}")
    in_window = committed_between(text, t_run_utc, t_run_utc + wall)  # every node's commit lines
    txs = committed_txs({"deploy": text}, LOCAL_BENCH["tx_size"], (t_run_utc, t_run_utc + wall))["deploy"]
    launches, lanes = deploy_launches(dump), node_dump_lanes(dump)
    max_batch = int(dump["histograms"]["verifier.batch_size"]["max"])
    full = max(r for r, by in counts.items() if sum(by.values()) == n)
    result = dict(rounds=len(counts), newest_full_round=full, blocks_in_traffic=in_window,
                  blocks_per_s=in_window / n / wall, tx_per_s=txs / wall, lanes=lanes, launches=launches,
                  widths=deploy_widths(max_batch), timings=node_dump_timings(dump), wall_s=wall, up_s=up_s)
    print(f"port deploy: {n} nodes in one process on one TorchBackend (--crypto-crossover 1), up with "
          f"{n} clients in {up_s:.1f} s, {wall:.1f} s of client traffic ({LOCAL_BENCH['rate']} tx/s of "
          f"{LOCAL_BENCH['tx_size']} B in all): {len(counts)} rounds committed, each by all {n} nodes with one "
          f"digest up to round {full}; {in_window} commit lines within the traffic, "
          f"{result['blocks_per_s']:.2f} blocks/s a node; {txs} transactions, {result['tx_per_s']:.1f} tx/s; "
          f"lanes {lanes}; launches { {k: v for k, v in launches.items() if v} }; largest batch {max_batch}, "
          f"widths {result['widths']} (each held in phase 2); p50 / p99 ms and card batches {result['timings']}; "
          f"phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)
    return result


# --- phase 8: BLS aggregation ------------------------------------------------

BLS_SIZES = (4, 16, 64, 128, 256)  # bench.py --agg-sizes' 4, 16, 64; the agg_certs chaos cells' 128; bls.py's 256
BLS_ROWS = 1024  # certificate bitmaps a call
BLS_VERIFY_SIZES = (64, 256)
BLS_FIELD_VALUES = 64  # residues of the field check: the edges and random ones, every pair (4,096)
BLS_POOL = 8  # processes of the key and exact-fold pool
BLS_WALL_REPS = 5  # aggregate_masks' wall and its stages, in turns


def _bls_fold(args: tuple[list, list[list[int]]]) -> list:
    """The exact integer fold `_FP_OPS.add_affine` over each row's members
    (a spawned worker: a picklable top-level function)."""
    from hotstuff_tpu_torch.crypto import aggsig

    points, rows = args
    out = []
    for members in rows:
        acc = None
        for i in members:
            acc = aggsig._FP_OPS.add_affine(acc, points[i])
        out.append(acc)
    return out


def bls_bound(masks, present, identity=None) -> tuple[int, int]:
    """K6's least work for these rows: (bytes, INT32 operations). Bytes: the
    mask, the table and the output, each once; operations: one mixed add
    per member beyond a row's first, counted from the mask. With
    `identity` ((B,) flags, 1 where a row's sum is the identity) the
    affine entry's: (2, 12) limbs and a flag a row out, and the conversion
    of every other row, BLS_OPS_PER_AFFINE each and BLS_OPS_PER_CHAIN once."""
    import numpy as np

    rows, n = masks.shape
    members = (np.asarray(masks, bool) & np.asarray(present, bool)[None]).sum(1)
    ops = int(np.maximum(members - 1, 0).sum()) * BLS_OPS_PER_MEMBER
    table = n * (2 * 12 * 4 + 1)
    if identity is None:
        return rows * n + table + rows * 3 * 12 * 4, ops
    convert = rows - int(np.count_nonzero(np.asarray(identity)))
    ops += convert * BLS_OPS_PER_AFFINE + (BLS_OPS_PER_CHAIN if convert else 0)
    return rows * n + table + rows * (2 * 12 * 4 + 1), ops


def phase_bls_field(seed: int, device: str = "cuda") -> dict:
    """K6's Montgomery product alone (`hs_bls_mont_mul`) against Python ints
    and the plain `mont_mul` on every pair of BLS_FIELD_VALUES residues: 0,
    1, p - 1, p, 2p - 1 and random ones below 2p."""
    import random

    import torch

    from hotstuff_tpu_torch.breakdown import queued_ms
    from hotstuff_tpu_torch.ops import bls

    p = bls.P
    rng = random.Random(seed)
    vals = [0, 1, p - 1, p, 2 * p - 1]
    vals += [rng.randrange(2 * p) for _ in range(BLS_FIELD_VALUES - len(vals))]
    a_int = [x for x in vals for _ in vals]
    b_int = [y for _ in vals for y in vals]
    dev = torch.device(device)
    a = bls.to_i32(bls.limbs_of_int(a_int)).to(dev)
    b = bls.to_i32(bls.limbs_of_int(b_int)).to(dev)
    got = bls.mont_mul_device(a, b)
    plain_ms, want = _plain_ms(lambda: bls.to_i32(bls.mont_mul(bls.from_i32(a), bls.from_i32(b))))
    if not torch.equal(got, want):
        fail("hs_bls_mont_mul differs from the plain mont_mul")
    if bls.int_of_limbs(got.cpu()) != [x * y * bls.R_INV % p for x, y in zip(a_int, b_int)]:
        fail("hs_bls_mont_mul differs from Python ints")
    n = len(a_int)
    res = dict(ms=queued_ms(lambda: bls.mont_mul_device(a, b), 20), plain_ms=plain_ms, max_abs_err=_max_abs(got, want),
               bytes=n * 3 * 12 * 4, ops=n * BLS_OPS_PER_PRODUCT)
    res["bound_ms"], res["bound_by"] = _bound_ms(res["bytes"], res["ops"])
    print(f"bls_mont_mul: kernel equals the plain mont_mul and Python ints on {n} pairs (0, 1, p - 1, p, 2p - 1 "
          f"and random residues below 2p); {res['ms']:.4f} ms per {n}-pair call", flush=True)
    return res


def phase_bls(seed: int, device: str = "cuda") -> dict:
    """Phase 8 (see the module docstring): tables at BLS_SIZES, BLS_ROWS rows
    each through `CommitteeTable.aggregate_masks` with the launch counts
    read around them and `verify_aggregate` at BLS_VERIFY_SIZES; every sum
    against the exact integer fold, K6 against its plain version limb for
    limb, then the times."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch import bls_corpus
    from hotstuff_tpu_torch.breakdown import queued_ms
    from hotstuff_tpu_torch.crypto import aggsig
    from hotstuff_tpu_torch.ops import _build, bls

    field = phase_bls_field(seed, device)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(BLS_POOL, os.cpu_count() or 1)) as pool:
        t0 = time.perf_counter()
        pairs = pool.map(bls_corpus.keypair, bls_corpus.validator_seeds(max(BLS_SIZES)))
        print(f"BLS keys: {len(pairs)} ExactBlsScheme keypairs in {time.perf_counter() - t0:.1f} s", flush=True)
        corpus, folds = {}, {}
        for n in BLS_SIZES:
            keys, sks, lanes = bls_corpus.table_keys(pairs, n)
            masks, labels = bls_corpus.bitmap_rows(seed, n, lanes, BLS_ROWS)
            points = [None if sk is None else aggsig.decompress_g1(k) for k, sk in zip(keys, sks)]
            corpus[n] = (keys, sks, lanes, masks, labels, points)
            rows = [np.flatnonzero(r).tolist() for r in masks]
            step = -(-len(rows) // BLS_POOL)
            folds[n] = pool.map_async(_bls_fold, [(points, rows[i:i + step]) for i in range(0, len(rows), step)])

        tables, build_s = {}, {}
        for n in BLS_SIZES:
            t0 = time.perf_counter()
            tables[n] = bls.CommitteeTable(corpus[n][0], device=device)
            build_s[n] = time.perf_counter() - t0
            if tables[n].points != corpus[n][5] or tables[n].invalid.tolist() != [i == n - 1 for i in range(n)]:
                fail(f"BLS table at N = {n}: points or invalid lanes differ from the keys' own")
        print(f"BLS table build (decompress on the host, upload): "
              f"{', '.join(f'N={n} {s:.4f} s' for n, s in build_s.items())}", flush=True)

        # The path, counted: one aggregate_masks call per size, then the
        # verify_aggregate cases, each aggregating once unless refused.
        verify = {}
        for n in BLS_VERIFY_SIZES:
            keys, sks, lanes, *_ = corpus[n]
            bitmap = sum(1 << i for i in range(n) if sks[i] is not None)
            sig = aggsig.ExactBlsScheme().sign(sum(s for s in sks if s is not None) % aggsig.R_ORDER, b"agg-qc %d" % n)
            verify[n] = [(bitmap, b"agg-qc %d" % n, sig, True), (bitmap, b"another digest", sig, False),
                         (bitmap | 1 << lanes["invalid"][0], b"agg-qc %d" % n, sig, False), (0, b"agg-qc %d" % n, sig, False)]
        _build.reset_launches()
        sums, agg_s, verdicts, verify_s = {}, {}, {}, {}
        for n in BLS_SIZES:
            t0 = time.perf_counter()
            sums[n] = tables[n].aggregate_masks(corpus[n][3])
            agg_s[n] = time.perf_counter() - t0
        for n in BLS_VERIFY_SIZES:
            verdicts[n], verify_s[n] = [], []
            for bitmap, msg, sig, _ in verify[n]:
                t0 = time.perf_counter()
                verdicts[n].append(tables[n].verify_aggregate(bitmap, msg, sig))
                verify_s[n].append(time.perf_counter() - t0)
        launches = _build.launches()
        print(f"BLS path launches: {launches}", flush=True)
        want_launches = len(BLS_SIZES) + 3 * len(BLS_VERIFY_SIZES)  # the invalid-lane bitmap is refused first
        if device == "cuda" and launches != {k: (want_launches if k == "g1_aggregate_affine" else 0)
                                             for k in launches}:
            fail(f"the BLS path did not launch K6's affine entry once per aggregation, and nothing else: {launches}")
        for n in BLS_VERIFY_SIZES:
            if verdicts[n] != [v for *_, v in verify[n]]:
                fail(f"verify_aggregate at N = {n}: verdicts {verdicts[n]}, expected {[v for *_, v in verify[n]]}")
        for n in BLS_SIZES:
            exact = [pt for part in folds[n].get() for pt in part]
            if sums[n] != exact:
                bad = [i for i, (a, b) in enumerate(zip(sums[n], exact)) if a != b]
                fail(f"BLS sums at N = {n} differ from the exact fold on {len(bad)} rows, e.g. {bad[:8]}")
            named = dict(zip(corpus[n][4], sums[n]))
            if any(named[k] is not None for k in ("empty", "inverse", "invalid", "inverse_one_partial") if k in named):
                fail(f"BLS edge rows at N = {n}: {named}")
    print(f"BLS aggregation: every affine sum equals the exact add_affine fold at N = {list(BLS_SIZES)} "
          f"({BLS_ROWS} rows each: random quorums, empty, all, single, duplicate and inverse pairs, invalid lane); "
          f"verify_aggregate verdicts {verdicts} as expected", flush=True)

    # Both K6 entries against their plain versions on the same tensors,
    # limb for limb and flag for flag, at every size and at B = 1.
    err = err_aff = 0
    n_top = BLS_SIZES[-1]
    for n in BLS_SIZES:
        t = tables[n]
        rows = torch.from_numpy(corpus[n][3]).to(t.device)
        last = rows[-1:].contiguous()
        got, one = bls.g1_aggregate(t.tx, t.ty, t.present, rows), bls.g1_aggregate(t.tx, t.ty, t.present, last)
        (lim, flags), (lim1, flags1) = (bls.g1_aggregate_affine(t.tx, t.ty, t.present, r) for r in (rows, last))
        if n == n_top:
            plain_ms, want = _plain_ms(lambda: bls.g1_aggregate_plain(t.tx, t.ty, t.present, rows))
            plain_aff_ms, (want_lim, want_flags) = _plain_ms(
                lambda: bls.g1_aggregate_affine_plain(t.tx, t.ty, t.present, rows))
        else:
            want = bls.g1_aggregate_plain(t.tx, t.ty, t.present, rows)
            want_lim, want_flags = bls.g1_aggregate_affine_plain(t.tx, t.ty, t.present, rows)
        if not torch.equal(got, want) or not torch.equal(one, want[:, :, -1:]):
            fail(f"K6 g1_aggregate differs from its plain version at N = {n}")
        if not (torch.equal(lim, want_lim) and torch.equal(flags, want_flags)
                and torch.equal(lim1, want_lim[:, :, -1:]) and torch.equal(flags1, want_flags[-1:])):
            fail(f"K6 g1_aggregate_affine differs from its plain version at N = {n}")
        if bls.affine_of_limbs(lim, flags) != sums[n]:
            fail(f"K6 g1_aggregate_affine at N = {n} differs from aggregate_masks' sums")
        err = max(err, _max_abs(got, want), _max_abs(one, want[:, :, -1:]))
        err_aff = max(err_aff, _max_abs(lim, want_lim), _max_abs(flags, want_flags),
                      _max_abs(lim1, want_lim[:, :, -1:]), _max_abs(flags1, want_flags[-1:]))
    t = tables[n_top]
    masks = corpus[n_top][3]
    rows = torch.from_numpy(masks).to(t.device)
    last = rows[-1:].contiguous()
    ms = queued_ms(lambda: bls.g1_aggregate(t.tx, t.ty, t.present, rows), 20)
    ms_b1 = queued_ms(lambda: bls.g1_aggregate(t.tx, t.ty, t.present, last), 20)
    aff_ms = queued_ms(lambda: bls.g1_aggregate_affine(t.tx, t.ty, t.present, rows), 20)
    aff_ms_b1 = queued_ms(lambda: bls.g1_aggregate_affine(t.tx, t.ty, t.present, last), 20)
    # aggregate_masks' wall, then its stages run by hand in the same order
    # (mask upload and the affine K6 to a synchronize, readback, reading the
    # limbs into ints), in turns; medians of BLS_WALL_REPS.
    walls, stages = [], []
    for _ in range(BLS_WALL_REPS):
        t0 = time.perf_counter()
        t.aggregate_masks(masks)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        lim, flags = bls.g1_aggregate_affine(t.tx, t.ty, t.present, torch.from_numpy(masks).to(t.device))
        if t.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        lim, flags = lim.cpu(), flags.cpu()
        t2 = time.perf_counter()
        bls.affine_of_limbs(lim, flags)
        stages.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    wall = statistics.median(walls) * 1e3
    device_leg, readback, conv = (statistics.median(x) * 1e3 for x in zip(*stages))
    present = t.present.cpu().numpy()
    res, aff = {}, {}
    for row, entry_ms, entry_plain, entry_err, identity in ((res, ms, plain_ms, err, None),
                                                            (aff, aff_ms, plain_aff_ms, err_aff, want_flags.cpu())):
        row.update(ms=entry_ms, plain_ms=entry_plain, max_abs_err=entry_err)
        row["bytes"], row["ops"] = bls_bound(masks, present, identity)
        row["bound_ms"], row["bound_by"] = _bound_ms(row["bytes"], row["ops"])
        row["extra"] = dict(share=row["bound_ms"] / entry_ms if entry_ms else 0.0)
    res["extra"].update(ms_b1=ms_b1, table_build_s=build_s)
    aff["extra"].update(ms_b1=aff_ms_b1, aggregate_masks_wall_ms=wall,
                        upload_and_kernel_ms=device_leg, readback_ms=readback, affine_of_limbs_ms=conv)
    print(f"K6: both entries identical to their plain versions (limbs, flags) at N = {list(BLS_SIZES)} with "
          f"B = {BLS_ROWS} and B = 1; at N = {n_top}: fold alone {ms:.4f} ms at B = {BLS_ROWS}, {ms_b1:.4f} ms at "
          f"B = 1, plain {plain_ms:.1f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}, {res['ops']} "
          f"operations, {res['bytes']} bytes), share {res['extra']['share']:.2%}; affine {aff_ms:.4f} ms at "
          f"B = {BLS_ROWS}, {aff_ms_b1:.4f} ms at B = 1, plain {plain_aff_ms:.1f} ms, bound {aff['bound_ms']:.4f} ms "
          f"({aff['bound_by']}, {aff['ops']} operations, {aff['bytes']} bytes), share {aff['extra']['share']:.2%}",
          flush=True)
    print(f"aggregate_masks at N = {n_top}, B = {BLS_ROWS}: {wall:.2f} ms wall (median of {BLS_WALL_REPS}; first "
          f"call {agg_s[n_top] * 1e3:.2f} ms); its stages by hand: mask upload and the affine K6 to a synchronize "
          f"{device_leg:.3f} ms (K6 alone {aff_ms:.4f} ms on the device), readback {readback:.3f} ms, "
          f"affine_of_limbs {conv:.3f} ms", flush=True)
    for n in BLS_VERIFY_SIZES:
        bitmap = verify[n][0][0]
        t0 = time.perf_counter()
        tables[n].aggregate_bitmaps([bitmap])
        agg = time.perf_counter() - t0
        total = verify_s[n][0]
        print(f"verify_aggregate at N = {n} (right message): {total:.3f} s wall: aggregation {agg * 1e3:.2f} ms, "
              f"pairing and the rest {total - agg:.3f} s; refused invalid-lane bitmap {verify_s[n][2] * 1e3:.3f} ms",
              flush=True)
    return dict(kernels={"g1_aggregate": res, "g1_aggregate_affine": aff, "bls_mont_mul": field}, launches=launches)


def off_path_errors(launch_sets: dict, names) -> list[str]:
    """Where a launch set counts a launch of one of the named kernels."""
    return [f"{label}: {k} launched {d[k]} times" for label, d in launch_sets.items() for k in names if d.get(k)]


def bls_off_path_errors(launch_sets: dict) -> list[str]:
    """Where a phase of the ed25519 paths launched a BLS kernel."""
    return off_path_errors(launch_sets, ("g1_aggregate", "g1_aggregate_affine", "bls_mont_mul"))


# --- phase 9: the f32-argument path and kernel K7 ----------------------------

F32_WIDTHS = (7, 1001)  # K7 against its plain version at these widths beside LANES and MAX_BUCKET
# (neither a whole number of K7's 8-lane blocks: each puts a tail quad on the card)
F32_KERNELS = ("bits", "w4", "pallas")
F32_MESH_KERNELS = ("bits", "w4")
F32_ITERS = 3  # timed batches per flavour
F32_TRACE_TRIES = 3  # traced batches per flavour until one trace holds every launch
F32_HIGH_S = 8  # valid signatures given s + 2^253
F32_LEG_KERNELS = {
    "bits": ("decompress_table", "bit_ladder", "compress_eq"),
    "w4": ("decompress_table", "ladder", "compress_eq"),
    "pallas": ("decompress_table", "ladder", "compress_eq"),
}

def bit_ladder_bound(s_bits, h_bits) -> tuple[int, int]:
    """(bytes, operations) K7's function needs on these bits: both bit rows,
    -A's three precomp coordinates (entry 1 of the table), B's and the
    (4, 10) point written; the doublings of every lane and a mixed add per
    set bit."""
    from hotstuff_tpu_torch.ops import field

    lanes, nl = s_bits.shape[1], field.NL
    set_bits = int(s_bits.sum()) + int(h_bits.sum())
    ops = lanes * s_bits.shape[0] * BIT_DBL_PRODUCTS + set_bits * BIT_MADD_PRODUCTS
    return lanes * (2 * s_bits.shape[0] + 3 * nl * 4 + 4 * nl * 4) + 3 * nl * 4, ops


def ptxas_numbers(text: str) -> dict:
    """Registers, stack frame bytes and spill bytes of a ptxas -v report."""
    from hotstuff_tpu_torch.ops import _build

    regs = re.findall(r"Used (\d+) registers", text)
    stack = re.findall(r"(\d+) bytes stack frame", text)
    return dict(registers=max(map(int, regs), default=None), stack=max(map(int, stack), default=None),
                spills=_build.spill_bytes(text))


def traced_launches(tr: dict, names) -> dict:
    """Launches of each named hand-written kernel in a read trace
    (`breakdown.read_device_trace`'s `kernel_counts`), by the CUDA symbol
    `<name>_kernel(` of each, in or out of a namespace."""
    pats = {n: re.compile(rf"(?:^|::|\s){n}_kernel\(") for n in names}
    return {n: sum(c for k, c in tr["kernel_counts"].items() if p.search(k)) for n, p in pats.items()}


def high_s_batch(batch, n: int):
    """The first n valid signatures of the batch with s + 2^253 (bits 0..252
    still s)."""
    import numpy as np

    M, K, S, expected = batch
    idx = np.flatnonzero(expected)[:n]
    high = [S[i][:32] + (int.from_bytes(S[i][32:], "little") + 2**253).to_bytes(32, "little") for i in idx]
    return [M[i] for i in idx], [K[i] for i in idx], high


def phase_bit_ladder(seed: int, device: str = "cuda") -> dict:
    """Phase 9's first step: K7 against its plain version on random bits and
    K3's table of random keys, exactly, at the widths of F32_WIDTHS, at
    LANES and at MAX_BUCKET (the f32 path's pieces run K7 at MAX_BUCKET
    lanes), then its times, bound and ptxas. The row's numbers are those at
    LANES; `extra` holds those at 128 lanes and at MAX_BUCKET."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.breakdown import queued_ms
    from hotstuff_tpu_torch.ops import _build
    from hotstuff_tpu_torch.ops import bit_ladder as bl
    from hotstuff_tpu_torch.ops import ed25519 as ed

    dev = torch.device(device)
    rng = np.random.default_rng(seed + 9)
    width = max(LANES, MAX_BUCKET)
    keys = torch.from_numpy(rng.integers(0, 256, (32, width), np.uint8)).to(dev)
    table, _ = ed.decompress_table(keys)
    sb = torch.from_numpy(rng.integers(0, 2, (ed.SCALAR_BITS, width), np.uint8)).to(dev)
    hb = torch.from_numpy(rng.integers(0, 2, (ed.SCALAR_BITS, width), np.uint8)).to(dev)
    full = bl.bit_ladder(sb, hb, table)
    widths = sorted({w for w in F32_WIDTHS if w < width} | {LANES, MAX_BUCKET})
    at = {}  # width -> (args, plain ms, max |diff|)
    for w in widths:
        args = (_cut(sb, w), _cut(hb, w), _cut(table, w))
        got = bl.bit_ladder(*args)
        plain_ms, want = _plain_ms(lambda: bl.bit_ladder_plain(*args))
        err = _max_abs(got, want)
        if err != 0 or not torch.equal(got, _cut(full, w)):
            fail(f"K7 bit_ladder differs from its plain version at width {w} (max |diff| {err})")
        at[w] = (args, plain_ms, err)
    w_small = min(128, LANES)
    small = (_cut(sb, w_small), _cut(hb, w_small), _cut(table, w_small))
    ms_small = queued_ms(lambda: bl.bit_ladder(*small), 20)
    timed = {}
    for w in (LANES, MAX_BUCKET):
        args, plain_ms, err = at[w]
        bytes_moved, ops = bit_ladder_bound(*args[:2])
        bound_ms, bound_by = _bound_ms(bytes_moved, ops)
        ms = queued_ms(lambda: bl.bit_ladder(*args), 5)
        timed[w] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bytes=bytes_moved, ops=ops,
                        bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms if ms else 0.0)
    res, wide = dict(timed[LANES]), timed[MAX_BUCKET]
    ptxas = ptxas_numbers(_build.ptxas_report().get("bit_ladder", ""))
    print(f"K7: raw limbs identical to the plain version at widths {widths}; {ms_small:.4f} ms at {w_small} "
          f"lanes, {res['ms']:.4f} ms at {LANES}, {wide['ms']:.4f} ms at {MAX_BUCKET}; plain "
          f"{res['plain_ms']:.1f} ms at {LANES}, {wide['plain_ms']:.1f} ms at {MAX_BUCKET}; bound at {LANES} "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}, {res['ops']} products, {res['bytes']} bytes), "
          f"{100 * res['share']:.1f}% of it; at {MAX_BUCKET} {wide['bound_ms']:.4f} ms, "
          f"{100 * wide['share']:.1f}%; ptxas {ptxas}", flush=True)
    res["extra"] = dict(ms_128=ms_small, share=res.pop("share"), **{f"{k}_{MAX_BUCKET}": wide[k] for k in (
        "ms", "plain_ms", "bound_ms", "share")}, **ptxas)
    return res


def phase_f32(seed: int, batch, device: str = "cuda") -> dict:
    """Phase 9 (see the module docstring)."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.breakdown import device_trace
    from hotstuff_tpu_torch.ops import _build, ladder
    from hotstuff_tpu_torch.ops import ed25519 as ed
    from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
    from hotstuff_tpu_torch.parallel import ShardedEd25519TorchVerifier, sharded_verify

    t_phase = time.perf_counter()
    dev = torch.device(device)
    res = phase_bit_ladder(seed, device)

    # The f32 path on phase 3's batch, each flavour: the counted run, timed
    # batches, one traced batch.
    M, K, S, expected = batch
    rates, leg_launches, traced = {}, {}, {}
    for k in F32_KERNELS:
        v = Ed25519TorchVerifier(device=device, kernel=k, packed=False, max_bucket=MAX_BUCKET, chunk=CHUNK)
        try:
            _build.reset_launches()
            mask = v.verify_batch_mask(M, K, S)
            launches = _build.launches()
            pieces = -(-len(M) // v.max_bucket)
            want = {name: pieces if name in F32_LEG_KERNELS[k] else 0 for name in launches}
            if device == "cuda" and launches != want:
                fail(f"f32 path {k}: launches {launches}, expected {want}")
            if mask.tolist() != np.asarray(expected).tolist():
                bad = np.flatnonzero(mask != np.asarray(expected))
                fail(f"f32 path {k}: mask differs from expected on {len(bad)} lanes, e.g. {bad[:8].tolist()}")
            times = []
            for _ in range(F32_ITERS):
                t0 = time.perf_counter()
                again = v.verify_batch_mask(M, K, S)
                times.append(time.perf_counter() - t0)
                if not np.array_equal(again, mask):
                    fail(f"f32 path {k}: mask changed between batches")
            # The profiler may lose a piece's events: a trace whose
            # kernels fall short of the counted launches is read only for
            # its streams; its busy share is not kept.
            for attempt in range(1, F32_TRACE_TRIES + 1 if device == "cuda" else 0):
                out = []
                tr = device_trace(lambda: out.append(v.verify_batch_mask(M, K, S)),
                                  REPO / ".chip_smoke" / f"trace_f32_{k}.json")
                if not np.array_equal(out[0], mask) or tr["on_default_stream"]:
                    fail(f"f32 path {k}: traced batch changed its mask or put work on the default stream ({tr})")
                seen = traced_launches(tr, F32_LEG_KERNELS[k])
                traced[k] = dict(launches_seen=seen, tries=attempt, **{key: tr[key] for key in (
                    "busy_share", "device_ms", "device_ms_sum", "wall_ms", "kernels", "streams")},
                    device_ms_by_name={n[:48]: ms for n, ms in tr["device_ms_by_name"].items()})
                if seen == {name: pieces for name in F32_LEG_KERNELS[k]}:
                    break
            else:
                if device == "cuda":
                    traced[k] = dict(incomplete=True, launches_seen=traced[k]["launches_seen"],
                                     streams=traced[k]["streams"])
        finally:
            v.close()
        rates[k] = len(M) * F32_ITERS / sum(times)
        leg_launches[k] = launches
        print(f"f32 path {k}: {len(M)} signatures in {pieces} pieces, mask == expected, launches "
              f"{ {n: c for n, c in launches.items() if c} }; {rates[k]:.1f} sigs/s (host clock, "
              f"{F32_ITERS} batches; per batch {[round(t * 1e3, 3) for t in times]} ms); "
              f"traced {traced.get(k)}", flush=True)

    # s + 2^253: bits 0..252 are s, so the bit ladder's raw mask is True
    # and the digit ladder's False, as the reference's; s < L fails both.
    hm, hk, hs = high_s_batch(batch, F32_HIGH_S)
    staged = ed.prepare_batch(hm, hk, hs, want_bits=True)
    raw = {k: ladder.verify_args(*(torch.from_numpy(a).to(dev) for a in ed.kernel_args(staged, len(hm), k)),
                                 kernel=k).cpu().tolist() for k in ("bits", "w4")}
    if raw != {"bits": [True] * len(hm), "w4": [False] * len(hm)} or staged["s_ok"].any():
        fail(f"s + 2^253 lanes: raw masks {raw}, s_ok {staged['s_ok'].tolist()}")

    # Where one piece's time goes, per flavour, host clock: staging
    # (`prepare_batch` and `kernel_args`), upload, then K3, the ladder and
    # K4 with the mask read back.
    piece = min(len(M), MAX_BUCKET)
    split = {}
    for k in F32_MESH_KERNELS:
        t0 = time.perf_counter()
        args = ed.kernel_args(ed.prepare_batch(M[:piece], K[:piece], S[:piece], want_bits=k == "bits"), piece, k)
        t1 = time.perf_counter()
        args = [torch.from_numpy(a).to(dev) for a in args]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        ladder.verify_args(*args, kernel=k).cpu()
        split[k] = dict(stage_ms=(t1 - t0) * 1e3, upload_ms=(t2 - t1) * 1e3,
                        kernels_and_readback_ms=(time.perf_counter() - t2) * 1e3)
    print(f"f32 piece of {piece} lanes, host clock: {split}", flush=True)

    # sharded_verify on the meshes against the single-device mask.
    staged = ed.prepare_batch(M[:piece], K[:piece], S[:piece], want_bits=True)
    mesh_res = {}
    for k in F32_MESH_KERNELS:
        args = [torch.from_numpy(a).to(dev) for a in ed.kernel_args(staged, piece, k)]
        single = ladder.verify_args(*args, kernel=k)
        for label, mesh in meshes(device).items():
            mask, n_valid = sharded_verify(mesh, *args, kernel=k)
            if not torch.equal(mask.cpu(), single.cpu()) or int(n_valid) != int(single.sum()):
                fail(f"sharded_verify {k} on mesh {label}: mask or n_valid ({int(n_valid)}) differs from the "
                     f"single-device mask (sum {int(single.sum())})")
            mesh_res[f"{k} {label}"] = int(n_valid)
    mesh_launches = {}
    for label, mesh in meshes(device).items():
        v = ShardedEd25519TorchVerifier(mesh=mesh, kernel="bits", packed=False, max_bucket=MAX_BUCKET, chunk=CHUNK)
        try:
            _build.reset_launches()
            mask = v.verify_batch_mask(M, K, S)
            launches = _build.launches()
            pieces = -(-len(M) // v.max_bucket)
        finally:
            v.close()
        want = {name: pieces * mesh.size if name in F32_LEG_KERNELS["bits"] else 0 for name in launches}
        if device == "cuda" and launches != want:
            fail(f"mesh {label} f32 bits: launches {launches}, expected {want}")
        if mask.tolist() != np.asarray(expected).tolist():
            fail(f"mesh {label} f32 bits: mask differs from expected")
        mesh_launches[label] = launches["bit_ladder"]
    print(f"f32 mesh: sharded_verify n_valid {mesh_res} equal to the single-device mask's sums over "
          f"{piece} lanes; ShardedEd25519TorchVerifier(packed=False, kernel='bits') on meshes "
          f"{list(meshes(device))}: masks == expected; s + 2^253 raw masks {raw}; "
          f"phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    res["extra"].update(f32_sigs_per_s=rates, traced=traced, f32_piece_split=split)
    return dict(kernel=res, launches=leg_launches["bits"], rates=rates, leg_launches=leg_launches,
                mesh_launches=mesh_launches)


def k7_off_path_errors(launch_sets: dict) -> list[str]:
    """Where a phase before phase 9 launched K7."""
    return off_path_errors(launch_sets, ("bit_ladder",))


# --- phase 10: device tuning: the radix-2^12 field (K8) and the tool --------

TUNING_KERNELS = ("field12", "field12_mul", "field12_sub", "field12_canonical", "field_sqr_n", "alu_chain")
FIELD12_CHAIN = 64  # the --field leg's squarings a call
ALU_SHAPE = (64, 4096)  # the --vpu leg's elements (tools/tune_device.py:39)
# The widths the tool's --chunks leg launches K2, K3, K1 and K4 at (its
# chunk sizes) beyond phase 2's LANES, widest first.
TUNE_WIDTHS = (16384, 8192, 2048)
TUNE_TIMEOUT_S = 300
TUNE_ARGS = ("--all",)
TUNE_CPU_ARGS = ("--cpu", "--lanes", "16", "--reps", "1", "--chain", "4")  # the rehearsal's: one chunk row
# Rows `python3 -m hotstuff_tpu_torch.tune_device --all` must print, by
# prefix; the chunk leg prints one row a (chunk, bucket) pair.
TUNE_ROWS = ("# devices:", "vpu f32 mul+add", "vpu i32 mul+add", "vpu u32 xor/shift/add",
             "field int32 radix-2^25.5", "field u32 radix-2^12", "field check: both rows equal",
             "phase decompress ", "phase decompress+table", "phase ladder", "phase compress",
             "phase sha512+modL (dh)", "phase full verify", "dh-compare host-hash", "dh-compare device-hash",
             "# launches:")
# Kernels the tool must launch on the card: its own two, K8's chain and
# canonical (the --field check), and the verify kernels of its other legs.
TUNE_PATH_KERNELS = ("alu_chain", "field_sqr_n", "field12", "field12_canonical",
                     "ladder", "h_digits", "decompress_table", "compress_eq")


def entry_ptxas(text: str, name: str) -> str:
    """The part of a source's `ptxas_report` line about the entry function
    `<name>_kernel` (its mangled name holds the length, then the name)."""
    pat = re.compile(rf"\d{name}_kernel")
    return " | ".join(part for part in text.split("Compiling entry function") if pat.search(part))


def _u32_err(a, b) -> int:
    """Largest |difference| of two tensors of uint32 bits."""
    from hotstuff_tpu_torch.ops.field import from_i32

    return (from_i32(a) - from_i32(b)).abs().max().item()


def field12_inputs(seed: int, device: str):
    """Phase 10's K8 operands at LANES: x with the edge values 0, 1, p - 1,
    2^255 - 20 first, y, their normalized products (limb 0 up to ~14k), and
    264-bit encodings for canonical (p, p + 1, 2p - 1, 2p, 2^264 - 1,
    500p + 7 first, as tests/test_field12.py:80-97). Returns (tensors, the
    encodings' ints)."""
    import random

    from hotstuff_tpu_torch.ops import field12 as f12

    rng = random.Random(seed + 10)
    edge = [0, 1, f12.P - 1, (1 << 255) - 20][:LANES]
    xs = edge + [rng.randrange(f12.P) for _ in range(LANES - len(edge))]
    ys = [rng.randrange(f12.P) for _ in range(LANES)]
    top = [f12.P, f12.P + 1, 2 * f12.P - 1, 2 * f12.P, (1 << 264) - 1, 500 * f12.P + 7][:LANES]
    cs = top + [rng.randrange(1 << 264) for _ in range(LANES - len(top))]
    x, y, c = (f12.tensor_of_ints(v, device) for v in (xs, ys, cs))
    m1, m2 = f12.mul_plain(x, y), f12.sqr_plain(y)
    return dict(x=x, y=y, c=c, m1=m1, m2=m2, lazy=f12.add(m1, m2), xy=f12.add(x, y)), cs


def field12_cases(t: dict) -> list:
    """(kernel, label, kernel call, plain call, operands) of phase 10's K8
    comparisons: mul on normalized operands and on one lazy add, sub on the
    lazy-add inputs the reference allows, canonical on the 264-bit domain
    and on real products, sqr_n with n = 1 and 64."""
    from hotstuff_tpu_torch.ops import field12 as f12

    sq = lambda n: (lambda a: f12.sqr_n(a, n), lambda a: f12.sqr_n_plain(a, n))
    return [
        ("field12_mul", "mul", f12.mul, f12.mul_plain, ("x", "y")),
        ("field12_mul", "mul lazy", f12.mul, f12.mul_plain, ("lazy", "m2")),
        ("field12_sub", "sub lazy", f12.sub, f12.sub_plain, ("lazy", "m2")),
        ("field12_sub", "sub", f12.sub, f12.sub_plain, ("xy", "y")),
        ("field12_canonical", "canonical 264-bit", f12.canonical, f12.canonical_plain, ("c",)),
        ("field12_canonical", "canonical of products", f12.canonical, f12.canonical_plain, ("m1",)),
        ("field12", "sqr_n 1", *sq(1), ("x",)),
        ("field12", f"sqr_n {FIELD12_CHAIN}", *sq(FIELD12_CHAIN), ("x",)),
        ("field12", f"sqr_n {FIELD12_CHAIN} of products", *sq(FIELD12_CHAIN), ("m1",)),
    ]


def _row(ms: float, plain_ms: float, err: int, bytes_moved: float, ops: float, **extra) -> dict:
    bound_ms, bound_by = _bound_ms(bytes_moved, ops)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bytes=bytes_moved, ops=ops, bound_ms=bound_ms,
                bound_by=bound_by, extra=dict(share=bound_ms / ms if ms else 0.0, **extra))


def phase_field12(seed: int, device: str = "cuda") -> dict:
    """Phase 10's comparisons and times: K8 against its plain version at every
    width of WIDTHS and at LANES, exactly (uint32 limbs, tolerance 0), and
    canonical against v mod p; `hs_field_sqr_n` against `field.sqr_n` and
    `hs_alu_chain` against its plain chains, exactly; then each kernel's
    device ms, its plain version's, the bound and the share (K8's
    `sqr_n(., 64)` at 128 lanes beside LANES), and ptxas. Returns the
    kernels' rows, with the launches the comparisons made."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.breakdown import queued_ms
    from hotstuff_tpu_torch.ops import _build, field
    from hotstuff_tpu_torch.ops import field12 as f12
    from hotstuff_tpu_torch.tune_device import alu_chain, alu_chain_plain

    t_phase = time.perf_counter()
    dev = torch.device(device)
    layout = f12.kernel_layout()
    print(f"K8 layout: sqr_n and mul {layout['threads_per_lane']} threads a lane (one in each warp of a block of "
          f"{layout['lanes_per_block']} lanes), rows per thread {layout['rows']}, products of a squaring "
          f"{layout['sqr_products']}, of a product {layout['mul_products']}; sub and canonical one thread a lane",
          flush=True)
    _build.reset_launches()
    t, cs = field12_inputs(seed, device)
    errs = {}
    for name, label, kernel, plain, keys in field12_cases(t):
        for w in _widths():
            args = [_cut(t[k], w) for k in keys]
            err = _u32_err(kernel(*args), plain(*args))
            if err != 0:
                fail(f"K8 {name} ({label}) differs from its plain version at width {w} (max |diff| {err})")
            errs[name] = max(errs.get(name, 0), err)
    canon = f12.canonical(t["c"])
    if f12.int_of_limbs(canon) != [v % f12.P for v in cs]:
        fail("K8 canonical differs from v mod p on the 264-bit domain")

    vals = f12.int_of_limbs(t["x"])
    x25 = field.limbs_of_int(vals).to(torch.int32).to(dev)
    for w in _widths():
        got, want = field.sqr_chain(_cut(x25, w), FIELD12_CHAIN), field.sqr_n(_cut(x25, w).long(), FIELD12_CHAIN)
        errs["field_sqr_n"] = _max_abs(got, want)
        if errs["field_sqr_n"] != 0:
            fail(f"hs_field_sqr_n differs from field.sqr_n at width {w} (max |diff| {errs['field_sqr_n']})")
    # The --vpu leg's inputs (1.0001 and 3 everywhere), then random ones.
    rng = np.random.default_rng(seed + 10)
    shape = (ALU_SHAPE[0], min(ALU_SHAPE[1], LANES))
    ints = torch.from_numpy(rng.integers(-2**31, 2**31, shape).astype(np.int32))
    alu_in = {0: [torch.full(shape, 1.0001), torch.from_numpy(rng.random(shape, np.float32))],
              1: [torch.full(shape, 3, dtype=torch.int32), ints], 2: [torch.full(shape, 3, dtype=torch.int32), ints]}
    alu_in = {op: [a.to(dev) for a in inputs] for op, inputs in alu_in.items()}
    errs["alu_chain"] = 0.0
    for op, inputs in alu_in.items():
        for a in inputs:
            for n in (3, FIELD12_CHAIN):
                got, want = alu_chain(a, op, n), alu_chain_plain(a, op, n)
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    fail(f"hs_alu_chain op {op} ({n} steps) differs from its plain version")
                errs["alu_chain"] = max(errs["alu_chain"], (got.double() - want.double()).abs().max().item())
    compare_launches = {k: _build.KERNELS[k].launches for k in TUNING_KERNELS}
    print(f"K8: uint32 limbs identical to the plain version at widths {_widths()} for "
          f"{[label for _, label, *_ in field12_cases(t)]}; canonical equal to v mod p on the 264-bit domain; "
          f"hs_field_sqr_n equal to field.sqr_n ({FIELD12_CHAIN} squarings) at the same widths; hs_alu_chain "
          f"equal to its plain chains (3 ops, {shape}, 3 and {FIELD12_CHAIN} steps)", flush=True)

    # Times: device ms with launches queued; the plain versions once; bounds.
    nb = f12.NLIMB * 4  # bytes of one lane's element
    x, y, w_small = t["x"], t["y"], min(128, LANES)
    x_small = _cut(x, w_small)
    rows = {}
    f12.PRODUCTS.n = 0
    plain_ms, _ = _plain_ms(lambda: f12.sqr_n_plain(x, FIELD12_CHAIN))
    ms_small = queued_ms(lambda: f12.sqr_n(x_small, FIELD12_CHAIN), 20)
    rows["field12"] = _row(queued_ms(lambda: f12.sqr_n(x, FIELD12_CHAIN), 20), plain_ms, errs["field12"],
                           2 * nb * LANES, f12.PRODUCTS.n * LANES, ms_128=ms_small, chain=FIELD12_CHAIN,
                           bound_ms_128=_bound_ms(2 * nb * w_small, f12.PRODUCTS.n * w_small)[0])
    f12.PRODUCTS.n = 0
    plain_ms, _ = _plain_ms(lambda: f12.mul_plain(x, y))
    rows["field12_mul"] = _row(queued_ms(lambda: f12.mul(x, y), 20), plain_ms, errs["field12_mul"],
                               3 * nb * LANES, f12.PRODUCTS.n * LANES)
    plain_ms, _ = _plain_ms(lambda: f12.sub_plain(t["lazy"], t["m2"]))
    # sub and canonical do no limb products; bytes bind them at every width.
    rows["field12_sub"] = _row(queued_ms(lambda: f12.sub(t["lazy"], t["m2"]), 20), plain_ms, errs["field12_sub"],
                               3 * nb * LANES, 0)
    plain_ms, _ = _plain_ms(lambda: f12.canonical_plain(t["c"]))
    rows["field12_canonical"] = _row(queued_ms(lambda: f12.canonical(t["c"]), 20), plain_ms,
                                     errs["field12_canonical"], 2 * nb * LANES, 0)
    field.PRODUCTS.n = 0
    plain_ms, _ = _plain_ms(lambda: field.sqr_n(x25.long(), FIELD12_CHAIN))
    rows["field_sqr_n"] = _row(queued_ms(lambda: field.sqr_chain(x25, FIELD12_CHAIN), 20), plain_ms, errs["field_sqr_n"],
                               2 * field.NL * 4 * LANES, field.PRODUCTS.n * LANES, chain=FIELD12_CHAIN)
    a = alu_in[1][0]
    plain_ms, _ = _plain_ms(lambda: alu_chain_plain(a, 1, FIELD12_CHAIN))
    op_ms = {op: queued_ms(lambda: alu_chain(alu_in[op][0], op, FIELD12_CHAIN), 20) for op in alu_in}
    # Op 1's step, x * x + 1 in uint32, is one IMAD: one INT32 operation.
    rows["alu_chain"] = _row(op_ms[1], plain_ms, errs["alu_chain"], 2 * 4 * a.numel(), FIELD12_CHAIN * a.numel(),
                             op="1 (i32 mul+add)", ms_by_op=op_ms, elements=a.numel(), chain=FIELD12_CHAIN)
    report = _build.ptxas_report()
    for name in TUNING_KERNELS:
        rows[name]["extra"].update(ptxas_numbers(entry_ptxas(report.get(_build.KERNELS[name].source, ""), name)),
                                   compare_launches=compare_launches[name])
    for name, res in rows.items():
        print(f"{name}: {res['ms']:.6f} ms at {LANES if name != 'alu_chain' else res['extra']['elements']} "
              f"{'lanes' if name != 'alu_chain' else 'elements'}, plain {res['plain_ms']:.3f} ms, bound "
              f"{res['bound_ms']:.6f} ms ({res['bound_by']}, {res['ops']} operations, {res['bytes']} bytes), "
              f"{100 * res['extra']['share']:.2f}% of it; {res['extra']}", flush=True)
    print(f"phase 10 comparisons and times took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def phase_wide_compare(seed: int, device: str = "cuda", widths: tuple = TUNE_WIDTHS) -> dict:
    """K2, K3, K1 and K4 at the widths the tool's --chunks leg launches them
    at, beyond phase 2's LANES: at the widest, the raw outputs equal the
    plain versions' on the same tensors, exactly (random rows and keys with
    phase 2's special keys, random digits over K3's table, K4's inputs of
    `_k4_inputs`); at each narrower width, the kernels' outputs equal the
    widest plain run's first lanes, which are the plain version's at that
    width since each lane is computed alone. Returns the launches."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops import _build, ladder, sha512
    from hotstuff_tpu_torch.ops import ed25519 as ed

    t0 = time.perf_counter()
    dev, n = torch.device(device), widths[0]
    rng = np.random.default_rng(seed + 14)
    rows = lambda k, hi=256: torch.from_numpy(rng.integers(0, hi, (k, n), np.uint8)).to(dev)
    _build.reset_launches()

    def hold(name: str, kernel, plain, *args):
        got, want = kernel(*args), plain(*args)
        as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
        if not all(torch.equal(g, p) for g, p in zip(as_tuple(got), as_tuple(want))):
            fail(f"{name} differs from its plain version at {n} lanes")
        for w in widths[1:]:
            cut = as_tuple(kernel(*(_cut(a, w) for a in args)))
            if not all(torch.equal(c, _cut(p, w)) for c, p in zip(cut, as_tuple(want))):
                fail(f"{name} differs from its plain version at {w} lanes")
        return want

    hold("K2 h_digits", sha512.h_digits, sha512.h_digits_plain, rows(32), rows(32), rows(32))
    keys = rows(32)
    for i, enc in enumerate(_special_keys()):
        keys[:, i] = torch.tensor(list(enc), dtype=torch.uint8, device=dev)
    table, _ = hold("K3 decompress_table", ed.decompress_table, ed.decompress_table_plain, keys)
    point = hold("K1 ladder", ladder.ladder, ladder.ladder_plain, rows(64, 16), rows(64, 16), table)
    xyzt, r_bytes, valid, want = _k4_inputs(rng, point, ed.compress(point), dev)
    if hold("K4 compress_eq", ed.compress_eq, ed.compress_eq_plain, xyzt, r_bytes, valid).cpu().tolist() != want:
        fail(f"K4 compress_eq differs from the mask known by construction at {n} lanes")
    launches = _build.launches()
    print(f"K2, K3, K1, K4 at the tool's chunk widths {list(widths)}: identical to their plain versions "
          f"({sum(want)}/{n} K4 lanes match); launches {launches}; {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def tune_missing(lines: list[str], chunk_rows: int) -> list[str]:
    """The rows of TUNE_ROWS (and `chunk_rows` chunk rows) that the tool's
    output lacks."""
    missing = [p for p in TUNE_ROWS if not any(ln.startswith(p) for ln in lines)]
    chunks = sum(ln.startswith("chunk ") for ln in lines)
    return missing + ([f"{chunk_rows} chunk rows ({chunks} printed)"] if chunks != chunk_rows else [])


def phase_tune(device: str = "cuda") -> dict:
    """Phase 10's run of the port's device tuning tool, as a user runs it:
    `python3 -m hotstuff_tpu_torch.tune_device --all` in its own process,
    with a time limit (on the CPU with TUNE_CPU_ARGS). Its lines are
    echoed; it must exit 0, print every leg's rows and, on the card, have
    launched each kernel of TUNE_PATH_KERNELS. Returns the tool's launch
    counts (its last line)."""
    from hotstuff_tpu_torch.tune_device import CHUNK_PAIRS

    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "hotstuff_tpu_torch.tune_device", *TUNE_ARGS,
           *(TUNE_CPU_ARGS if device == "cpu" else ())]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=TUNE_TIMEOUT_S)
    lines = proc.stdout.splitlines()
    for ln in lines:
        print(f"tune_device| {ln}", flush=True)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd[1:])} exited {proc.returncode}: {proc.stderr[-2000:]}")
    missing = tune_missing(lines, 1 if device == "cpu" else len(CHUNK_PAIRS))
    if missing:
        fail(f"the tuning tool did not print {missing}")
    launches = json.loads(lines[-1].split(":", 1)[1])
    if device == "cuda" and [k for k in TUNE_PATH_KERNELS if not launches.get(k)]:
        fail(f"the tuning tool did not launch {[k for k in TUNE_PATH_KERNELS if not launches.get(k)]}: {launches}")
    print(f"tune_device --all: exit 0, every leg's rows, launches {launches}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# --- phase 11: the port's bench -------------------------------------------------

BENCH_BASE = ("--batch", "16384", "--chunk", "4096", "--iters", "8", "--e2e-iters", "3")
BENCH_RUNS = (  # label, the run's flags after BENCH_BASE
    ("committee cache on", ("--committee-cache", "on", "--telemetry-port", "0")),
    ("committee cache off", ("--committee-cache", "off")),
    ("bits", ("--kernel", "bits", "--device-batch", "8192")),
    ("mesh", ("--mesh",)),
    ("pipeline A/B", ("--pipeline-ab",)),
    ("committee scale", ("--committee-scale", "--e2e-iters", "1", "--cpu-budget", "0.5")),
)
ROUTING_COUNTERS = ("crypto.tpu_batches", "crypto.tpu_sigs", "crypto.cpu_batches", "crypto.cpu_sigs",
                    "verifier.crossover_fallbacks", "verifier.committee_misses", "verifier.rejected_sigs",
                    "verifier.committee_rejected_sigs")
F32_KERNELS = {"w4": {"decompress_table", "ladder", "compress_eq"},
               "pallas": {"decompress_table", "ladder", "compress_eq"},
               "bits": {"decompress_table", "bit_ladder", "compress_eq"}}
PACKED_KERNELS = {"h_digits", "decompress_table", "ladder", "compress_eq"}
COMMITTEE_PATH_KERNELS = {"h_digits_idx", "committee_ladder", "compress_eq"}


def bench_kernels(argv) -> set[str]:
    """The kernels a bench run of `argv` must launch, and no others: the
    kernel-only leg's K3, K1 or K7, K4 and the verifier's packed kernels (the
    f32 path's with `--kernel bits`), plus the committee leg's; the pipeline
    A/B runs the verifier's only; the committee-scale table runs the
    committee kernels for the quorums that reach the card."""
    from hotstuff_tpu_torch.bench import parser

    args = parser().parse_args(list(argv))
    verifier = F32_KERNELS["bits"] if args.kernel == "bits" else PACKED_KERNELS
    if args.committee_scale:
        return set(COMMITTEE_PATH_KERNELS)
    if args.pipeline_ab:
        return set(verifier)
    out = F32_KERNELS[args.kernel] | verifier
    if args.committee_cache == "on":
        out |= COMMITTEE_PATH_KERNELS
    elif args.committee_cache == "off":
        out |= verifier
    return out


def bench_line(stdout: str) -> dict:
    """The bench's JSON line: the last line of its standard output."""
    lines = stdout.strip().splitlines()
    if not lines:
        fail("the bench printed nothing")
    try:
        line = json.loads(lines[-1])
    except json.JSONDecodeError:
        fail(f"the bench's last line does not parse: {lines[-1][:200]}")
    if not isinstance(line, dict):
        fail(f"the bench's last line is not an object: {lines[-1][:200]}")
    return line


def bench_errors(line: dict, launches: dict, want: set, dump: dict, device: str = "cuda") -> list[str]:
    """What a bench run got wrong: its line's backend and value, the kernels
    it launched against `want`, the routing counters in its metrics dump."""
    errors = []
    if line.get("backend") != device:
        errors.append(f"backend {line.get('backend')!r}, not {device!r}")
    if not (isinstance(line.get("value"), (int, float)) and line["value"] > 0):
        errors.append(f"value {line.get('value')!r} is not positive")
    launched = {k for k, n in launches.items() if n}
    if device == "cuda" and launched != want:
        errors.append(f"launched {sorted(launched)}, not {sorted(want)}")
    missing = [k for k in ROUTING_COUNTERS if k not in dump.get("counters", {})]
    if missing or "crypto.batch_size" not in dump.get("histograms", {}):
        errors.append(f"the metrics dump lacks {missing or ['crypto.batch_size']}")
    return errors


def run_bench(label: str, argv: list[str]) -> tuple[dict, dict, float, list[str]]:
    """`hotstuff_tpu_torch.bench.main(argv)` in this process, as a fresh
    process of the bench starts: the metrics registry, the flight recorder,
    the device timeline and the launch counts reset first. Echoes its
    standard output. Returns its JSON line (the last line, which must
    parse), the launches, the seconds and, as a list of errors, whether the
    line is what `main` returned."""
    import contextlib
    import io

    from hotstuff_tpu_torch import bench
    from hotstuff_tpu_torch.ops import _build, timeline
    from hotstuff_tpu_torch.utils import metrics, tracing

    metrics.reset()
    tracing.reset()
    timeline.reset()
    _build.reset_launches()
    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = bench.main(argv)
    secs = time.perf_counter() - t1
    launches = _build.launches()
    for ln in buf.getvalue().splitlines():
        print(f"bench {label}| {ln}", flush=True)
    line = bench_line(buf.getvalue())
    errors = [] if line == json.loads(json.dumps(ret)) else ["the last line is not what main returned"]
    return line, launches, secs, errors


def telemetry_errors(dump: dict, label: str) -> list[str]:
    """What a scrape of a telemetry endpoint got wrong: not a telemetry
    dump of `label`, or without the reference's SLO set."""
    from hotstuff_tpu_torch.utils import telemetry

    if not isinstance(dump, dict) or dump.get("kind") != "telemetry" or dump.get("node") != label:
        return [f"the scrape is not a telemetry dump of {label!r}: {str(dump)[:200]}"]
    slos = [s.get("name") for s in dump.get("slos") or ()]
    if slos != [s.name for s in telemetry.default_slos()]:
        return [f"{label}: the scrape's SLOs are {slos}"]
    return []


def bench_telemetry(label: str) -> list[str]:
    """One scrape of the endpoint a bench run opened with `--telemetry-port
    0` (`bench.TELEMETRY_PORT`), which is then closed. Returns its
    errors."""
    from hotstuff_tpu_torch import bench
    from hotstuff_tpu_torch.utils import telemetry

    try:
        dump = telemetry.scrape_sync(("127.0.0.1", bench.TELEMETRY_PORT))
    finally:
        bench.stop_telemetry()
    errors = telemetry_errors(dump, "bench")
    if not errors and not isinstance(dump.get("device"), dict):
        errors.append("the bench's scrape holds no device timeline")
    if not errors:
        dev = dump["device"]
        print(f"bench {label}: telemetry scrape of 127.0.0.1 ok: {len(dump['snapshots'])} snapshots, "
              f"active alerts {dump['active_alerts']}, device timeline {dev.get('chunks')} chunks, "
              f"occupancy {dev.get('occupancy')}", flush=True)
    return errors


def phase_bench(device: str = "cuda", base=BENCH_BASE, runs=BENCH_RUNS) -> dict:
    """Phase 11: `hotstuff_tpu_torch.bench.main(argv)` in this process for
    each run of `runs`, with the registry, the device timeline and the
    launch counts reset before it (as a fresh process of the bench starts)
    and `--metrics-out` to a file of its own. Each run's standard output
    is echoed; each must return normally, end with a JSON line equal to
    what `main` returned, with `backend` the device and a positive
    `value`, launch exactly `bench_kernels`' kernels (on the card) and
    leave a metrics dump with the routing counters. The committee-scale
    table's batches must each have taken one route. Returns each run's
    line and launches."""
    from hotstuff_tpu_torch import bench

    t0 = time.perf_counter()
    results = {}
    for label, flags in runs:
        path = _leg_paths(label)[0]
        argv = [*base, *flags, "--device", device, "--metrics-out", str(path)]
        line, launches, secs, errors = run_bench(label, argv)
        if "--telemetry-port" in flags:
            errors += bench_telemetry(label)
        errors += bench_errors(line, launches, bench_kernels(argv), json.loads(path.read_text()), device)
        if "committee_scale" in line:
            counters = json.loads(path.read_text())["counters"]
            iters = bench.parser().parse_args(argv).e2e_iters  # each QC a call, plus one first call a committee
            calls = sum(r["qcs"] for r in line["committee_scale"]) * iters + len(line["committee_scale"])
            routed = counters["crypto.tpu_batches"] + counters["crypto.cpu_batches"]
            if routed != calls or "mixed" in [r["route"] for r in line["committee_scale"]]:
                errors.append(f"committee scale: {routed} batches routed for {calls} calls, or a mixed route")
        if errors:
            fail(f"bench {label} ({' '.join(argv)}): {errors}")
        print(f"bench {label}: ok in {secs:.1f} s, launches "
              f"{ {k: n for k, n in launches.items() if n} }", flush=True)
        results[label] = {"line": line, "launches": launches, "seconds": secs}
    print(f"phase 11 (the port's bench): {len(runs)} runs in {time.perf_counter() - t0:.1f} s", flush=True)
    return results


# --- phase 12: the bench's AggQC, scheduler and client-plane legs ----------------

AGG_SIZES = (4, 16, 64, 256)  # bench.py's defaults 4-64, and the committee ops/bls.py is sized for
ENTRY_BYTES = {4: 428, 16: 1580, 64: 6188}  # the entry-list QCs of AGG_AB_r01.json
AGG_CERT_BYTES = 204  # 32 + 8 + the 64-byte bitmap + 4 + 96
INGRESS_RUNS = (  # label, flags: the reference's defaults (100 tx/s, flash x5, 10 s), then
    ("ingress 100 tx/s", ()),  # the lower rate of benchmark/fabfile.py's REMOTE_BENCH_PARAMS
    ("ingress 5000 tx/s", ("--ingress-rate", "5000")),
)
SCHED_FLAGS = ()  # the reference's defaults: bulk 512 x 3 feeders, critical 44 every 20 ms, 6 s a leg
FORCED_TXS = 256  # the forced ingress check: 4 batches of FORCED_BATCH
FORCED_BATCH = 64
FORCED_BAD_EVERY = 16  # 1/16 of the transactions carry a flipped signature bit
FORCED_TIMEOUT_S = 300


def _leg_paths(label: str) -> tuple[Path, Path]:
    out_dir = REPO / ".chip_smoke"
    out_dir.mkdir(exist_ok=True)
    stem = label.replace(" ", "_").replace("/", "")
    return out_dir / f"bench_metrics_{stem}.json", out_dir / f"bench_trace_{stem}.json"


def _leg_argv(flags, device: str, label: str) -> tuple[list[str], Path, Path]:
    metrics_path, trace_path = _leg_paths(label)
    return [*flags, "--device", device, "--metrics-out", str(metrics_path), "--trace-out", str(trace_path)], \
        metrics_path, trace_path


def _trace_errors(path: Path) -> list[str]:
    """A `--trace-out` dump must load and have the flight recorder's layout."""
    keys = {"v", "enabled", "node", "capacity", "recorded", "dropped", "anchor", "events"}
    try:
        dump = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"the trace dump does not load: {e}"]
    return [] if set(dump) == keys else [f"the trace dump's keys are {sorted(dump)}"]


def _leg_ok(label: str, secs: float, launches: dict) -> None:
    print(f"bench {label}: ok in {secs:.1f} s, launches { {k: n for k, n in launches.items() if n} }", flush=True)


def aggregate_errors(line: dict, launches: dict, sizes, device: str = "cuda") -> list[str]:
    """What the `--aggregate-ab` run got wrong: every certificate verified,
    each AggQC 204 bytes (spread 1.0), the entry-list bytes 44 + 96 n (the
    reference's at 4, 16 and 64), and on the card K6's affine entry once a
    `verify_aggregate` with no other kernel."""
    errors = []
    if line.get("all_verified") is not True:
        errors.append("not every certificate verified")
    rows = line.get("sizes", [])
    if [r["n"] for r in rows] != list(sizes):
        errors.append(f"sizes {[r['n'] for r in rows]}, not {list(sizes)}")
    for r in rows:
        if r["aggregate"]["cert_bytes"] != AGG_CERT_BYTES:
            errors.append(f"n={r['n']}: AggQC of {r['aggregate']['cert_bytes']} bytes")
        if r["entry_list"]["cert_bytes"] != ENTRY_BYTES.get(r["n"], 44 + 96 * r["n"]):
            errors.append(f"n={r['n']}: QC of {r['entry_list']['cert_bytes']} bytes")
    if line.get("agg_bytes_spread") != 1.0:
        errors.append(f"agg_bytes_spread {line.get('agg_bytes_spread')}")
    launched = {k: n for k, n in launches.items() if n}
    if device == "cuda" and launched != {"g1_aggregate_affine": len(sizes)}:
        errors.append(f"launched {launched}, not K6's affine entry {len(sizes)} times")
    return errors


def scheduler_errors(line: dict, launches: dict, device: str = "cuda") -> list[str]:
    """What the `--scheduler-ab` run got wrong: both legs verified, every
    mask all True, the legacy leg flushed through `_run_legacy` and the
    scheduler leg through `DeviceScheduler.run`, and on the card only K2,
    K3, K1 and K4 launched."""
    errors = []
    loops = {"legacy": "BatchVerificationService._run_legacy", "scheduler": "DeviceScheduler.run"}
    for leg, loop in loops.items():
        d = line.get(leg, {})
        if not d.get("verified_per_sec", 0) > 0 or not d.get("flushes", 0) > 0:
            errors.append(f"{leg}: nothing verified")
        if d.get("masks_all_true") is not True:
            errors.append(f"{leg}: a mask was not all True")
        if d.get("flush_loop") != loop:
            errors.append(f"{leg}: flushed through {d.get('flush_loop')!r}, not {loop}")
    launched = {k for k, n in launches.items() if n}
    if device == "cuda" and launched != PACKED_KERNELS:
        errors.append(f"launched {sorted(launched)}, not {sorted(PACKED_KERNELS)}")
    return errors


def ingress_errors(line: dict, launches: dict, dump: dict, device: str = "cuda") -> list[str]:
    """What an `--ingress` run got wrong: a rejected signature (every
    offered one is valid, so a failed dispatch shows here), committed
    unequal to the pipeline's accepted or to `ingress.forwarded`, a kernel
    launched beyond K2, K3, K1 and K4."""
    errors = []
    counters = dump.get("counters", {})
    if counters.get("ingress.rejected_sigs") != 0:
        errors.append(f"ingress.rejected_sigs {counters.get('ingress.rejected_sigs')}")
    committed = line.get("committed")
    if committed != line.get("pipeline", {}).get("accepted") or committed != counters.get("ingress.forwarded"):
        errors.append(f"committed {committed}, the pipeline accepted {line.get('pipeline', {}).get('accepted')}, "
                      f"forwarded {counters.get('ingress.forwarded')}")
    if not line.get("offered", 0) > 0:
        errors.append("nothing offered")
    launched = {k for k, n in launches.items() if n}
    if device == "cuda" and not launched <= PACKED_KERNELS:
        errors.append(f"launched {sorted(launched)}, beyond {sorted(PACKED_KERNELS)}")
    return errors


def curve_offered(curve: dict, duration: float) -> float:
    """Transactions a flash curve offers over `duration` s."""
    spike = max(0.0, min(curve["t_end"], duration) - curve["t_start"])
    return curve["rate"] * (duration - spike) + curve["peak"] * spike


def forced_ingress(seed: int, device: str = "cuda") -> dict:
    """The forced ingress check: FORCED_TXS transactions of the port's load
    generator (`random.Random(seed)`), every FORCED_BAD_EVERY-th with a bit
    of its signature flipped, submitted to an `IngressPipeline` over a
    `TorchBackend(device)` before its drain first runs, so that the drain
    takes FORCED_TXS / FORCED_BATCH batches of FORCED_BATCH onto the card.
    The drain keeps up to `DRAIN_WIDTH` batches in verification at once, so
    the scheduler may join them into fewer dispatches. Every status must be
    the one known by construction, every lane must reach the card, and there
    K2, K3, K1 and K4 must each launch once a dispatch, nothing else.
    Returns the launches."""
    import asyncio
    import random

    from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
    from hotstuff_tpu_torch.crypto.primitives import Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ingress import (ACCEPTED, BAD_SIGNATURE, ArrivalCurve, ClientTransaction, IngressConfig,
                                            IngressPipeline, OpenLoopLoadGen)
    from hotstuff_tpu_torch.ops import _build
    from hotstuff_tpu_torch.utils import metrics

    gen = OpenLoopLoadGen(None, ArrivalCurve(), 0.0, rng=random.Random(seed))
    txs, expected = [], []
    for i in range(FORCED_TXS):
        tx = gen._make_tx()
        if i % FORCED_BAD_EVERY == FORCED_BAD_EVERY // 2:
            sig = bytearray(tx.signature.data)
            sig[i % 32] ^= 1 << (i % 8)  # a bit of R
            tx = ClientTransaction(tx.client, tx.nonce, tx.fee, tx.body, Signature(bytes(sig)))
            expected.append(BAD_SIGNATURE)
        else:
            expected.append(ACCEPTED)
        txs.append(tx)
    backend = TorchBackend(device=device)

    async def drive():
        pipeline = IngressPipeline(BatchVerificationService(backend), asyncio.Queue(),
                                   IngressConfig(verify_batch=FORCED_BATCH))
        # gather schedules every submit before the drain task the first
        # one spawns, so admission holds all of them when the drain starts.
        return await asyncio.gather(*[pipeline.submit(tx) for tx in txs])

    metrics.reset()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        responses = asyncio.run(asyncio.wait_for(drive(), FORCED_TIMEOUT_S))
    finally:
        backend.close()
    secs = time.perf_counter() - t0
    launches = _build.launches()
    got = {r.nonce: r.status for r in responses}
    wrong = [i for i, (tx, want) in enumerate(zip(txs, expected)) if got.get(tx.nonce) != want]
    batches = FORCED_TXS // FORCED_BATCH
    launched = {k: n for k, n in launches.items() if n}
    errors = []
    if wrong:
        errors.append(f"{len(wrong)} statuses differ from the expected ones (transactions {wrong[:8]})")
    sizes = metrics.histogram("ingress.verify_batch_size", metrics.SIZE_BUCKETS).summary()
    if sizes["count"] != batches:
        errors.append(f"{sizes['count']} verification batches, not {batches}")
    dispatches = backend.stats["device_batches"]
    if not 1 <= dispatches <= batches:
        errors.append(f"{dispatches} dispatches to the card for {batches} batches")
    if device == "cuda" and launched != {k: dispatches for k in PACKED_KERNELS}:
        errors.append(f"launched {launched}, not K2, K3, K1 and K4 once each of {dispatches} dispatches")
    if backend.stats["device_sigs"] != FORCED_TXS:
        errors.append(f"{backend.stats['device_sigs']} lanes on the verifier, not {FORCED_TXS}")
    if errors:
        fail(f"forced ingress check: {errors}")
    bad = expected.count(BAD_SIGNATURE)
    print(f"forced ingress check: {FORCED_TXS} transactions, {bad} with a flipped signature bit, in "
          f"{batches} batches of {FORCED_BATCH} in {dispatches} dispatches: statuses exact, launches {launched}, "
          f"{secs:.2f} s", flush=True)
    return launches


def phase_bench_legs(seed: int, device: str = "cuda", agg_sizes=AGG_SIZES, sched_flags=SCHED_FLAGS,
                     ingress_runs=INGRESS_RUNS) -> dict:
    """Phase 12: the bench's `--aggregate-ab --agg-sizes`, `--scheduler-ab`
    and `--ingress` runs through `run_bench`, each with `--metrics-out` and
    `--trace-out` to files of its own under `.chip_smoke/` (gated by
    `aggregate_errors`, `scheduler_errors`, `ingress_errors`; every trace
    dump must load), then `forced_ingress`. Returns each run's line and
    launches by label."""
    from hotstuff_tpu_torch import bench

    t0 = time.perf_counter()
    results = {}

    label = "aggregate A/B"
    argv, mpath, tpath = _leg_argv(("--aggregate-ab", "--agg-sizes", ",".join(map(str, agg_sizes))), device, label)
    line, launches, secs, errors = run_bench(label, argv)
    errors += aggregate_errors(line, launches, agg_sizes, device) + _trace_errors(tpath)
    if errors:
        fail(f"bench {label}: {errors}")
    _leg_ok(label, secs, launches)
    for r in line["sizes"]:
        e, a = r["entry_list"], r["aggregate"]
        print(f"aggregate A/B n={r['n']}: QC {e['cert_bytes']} B, {e['verify_wall_s']} s ({r['n']} exact checks); "
              f"AggQC {a['cert_bytes']} B, {a['verify_wall_s']} s (K6 + pairing), table {a['table_build_s']} s",
              flush=True)
    results[label] = {"line": line, "launches": launches, "seconds": secs}

    label = "scheduler A/B"
    argv, mpath, tpath = _leg_argv(("--scheduler-ab", *sched_flags), device, label)
    line, launches, secs, errors = run_bench(label, argv)
    errors += scheduler_errors(line, launches, device) + _trace_errors(tpath)
    if errors:
        fail(f"bench {label}: {errors}")
    _leg_ok(label, secs, launches)
    for leg in ("legacy", "scheduler"):
        d = line[leg]
        print(f"scheduler A/B {leg} ({d['flush_loop']}): consensus p50/p99 "
              f"{d['critical_queue_ms'].get('p50_ms')}/{d['critical_queue_ms'].get('p99_ms')} ms, mempool "
              f"{d['bulk_queue_ms'].get('p50_ms')}/{d['bulk_queue_ms'].get('p99_ms')} ms, "
              f"{d['verified_per_sec']:,.1f} sigs/s, {d['flushes']} flushes", flush=True)
    print(f"scheduler A/B: p99_improvement {line['p99_improvement']}, verified_ratio {line['verified_ratio']}, "
          f"routes {line['routes']}", flush=True)
    results[label] = {"line": line, "launches": launches, "seconds": secs}

    for label, flags in ingress_runs:
        argv, mpath, tpath = _leg_argv(("--ingress", *flags), device, label)
        line, launches, secs, errors = run_bench(label, argv)
        dump = json.loads(mpath.read_text())
        errors += ingress_errors(line, launches, dump, device) + _trace_errors(tpath)
        if errors:
            fail(f"bench {label}: {errors}")
        _leg_ok(label, secs, launches)
        duration = bench.parser().parse_args(argv).ingress_duration
        c = dump["counters"]
        print(f"{label}: offered {line['offered']} ({line['offered_tps']} tx/s) against the curve's "
              f"{curve_offered(line['curve'], duration):.0f}; committed {line['committed']} "
              f"({line['committed_tps']} tx/s), shed {line['shed']}, latency p50/p99 "
              f"{line['latency_ms']['p50']}/{line['latency_ms']['p99']} ms; signer {line['signer']} at "
              f"{line['signer_sigs_per_s']} sigs/s; routes: card {c['crypto.tpu_batches']} batches / "
              f"{c['crypto.tpu_sigs']} sigs, host ({line['routes']['host_route']}) {c['crypto.cpu_batches']} / "
              f"{c['crypto.cpu_sigs']}", flush=True)
        results[label] = {"line": line, "launches": launches, "seconds": secs}

    results["forced ingress"] = {"line": None, "launches": forced_ingress(seed, device), "seconds": None}
    print(f"phase 12 (the bench's AggQC, scheduler and ingress legs): {len(results)} runs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


# --- phase 14: latch_probe, roofline and work stealing ----------------------------

STEAL_LANES = 4096  # the flood's lanes: phase 3's distinct signatures
STEAL_GROUP = 256  # lanes a verify_group call
STEAL_BUCKET = 512  # the service's max_batch, so that the flood makes several buckets


def _echo_main(label: str, fn, argv: list[str]):
    """`fn(argv)` in this process with its standard output echoed under
    `label`; returns (what it returned, its output lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"{label}| {ln}", flush=True)
    return ret, lines


def phase_latch_probe(device: str = "cuda", lanes: int | None = None) -> dict:
    """`python -m hotstuff_tpu_torch.latch_probe` (its `main`) on `device`:
    it must exit 0 with `contracts_held`, and on the card K2 must launch in
    its organic phase."""
    from hotstuff_tpu_torch import latch_probe

    argv = ["--device", device] + ([] if lanes is None else ["--lanes", str(lanes)])
    rc, lines = _echo_main("latch_probe", latch_probe.main, argv)
    summary = json.loads(lines[-1])
    if rc != 0 or not summary.get("contracts_held"):
        fail(f"latch_probe on {device}: rc {rc}, {summary}")
    if device == "cuda" and summary["organic_k2_launches"] <= 0:
        fail(f"latch_probe: K2 never launched in the organic phase: {summary}")
    return summary


def phase_roofline(rate: float, committee: int, rows: dict) -> dict:
    """`python -m hotstuff_tpu_torch.roofline --rate RATE --committee N`
    (its `main`): each kernel's bound it prints must equal the `bound_ms`
    of the kernel's row in this run's `rows` (the kernels line's)."""
    from hotstuff_tpu_torch import roofline

    out, _ = _echo_main("roofline", roofline.main, ["--rate", repr(rate), "--committee", str(committee)])
    diff = {name: (r["bound_ms"], rows[name]["bound_ms"]) for name, r in out["kernels"].items()
            if r["bound_ms"] != rows[name]["bound_ms"]}
    if diff:
        fail(f"roofline bounds differ from the kernels line's (roofline, line): {diff}")
    print(f"roofline: every bound equals the kernels line's ({sorted(out['kernels'])})", flush=True)
    return out


def phase_steal(batch, device: str = "cuda") -> dict:
    """Cross-backend work stealing: a `BatchVerificationService` over a home
    and one steal `TorchBackend` (crossover 1, both on `device`) takes a
    bulk flood of STEAL_LANES lanes in STEAL_GROUP-lane groups, max_batch
    STEAL_BUCKET. `pipeline.steals` must move, every mask must be the one
    known by construction, and the two backends' card lanes must add up to
    the lanes sent, with none on the host."""
    import asyncio

    import numpy as np

    from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.utils import metrics

    M, K, S, expected = batch
    n = min(STEAL_LANES, len(M))
    backends = [TorchBackend(device=device, crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK) for _ in range(2)]
    steals = metrics.counter("pipeline.steals")
    before = steals.value

    async def flood():
        svc = BatchVerificationService(backends[0], max_batch=STEAL_BUCKET, steal_backends=backends[1:])
        calls = [svc.verify_group(M[lo:lo + STEAL_GROUP], [(PublicKey(k), Signature(s)) for k, s in
                                                            zip(K[lo:lo + STEAL_GROUP], S[lo:lo + STEAL_GROUP])],
                                  source="mempool", dedup=False)
                 for lo in range(0, n, STEAL_GROUP)]
        masks = await asyncio.gather(*calls)
        return [b for m in masks for b in m], dict(svc.scheduler.stats)

    t0 = time.perf_counter()
    mask, stats = asyncio.run(flood())
    secs = time.perf_counter() - t0
    lanes = [b.stats["device_sigs"] for b in backends]
    host = sum(b.stats["host_sigs"] for b in backends)
    errors = []
    if stats["steals"] <= 0 or steals.value - before != stats["steals"]:
        errors.append(f"steals {stats['steals']}, pipeline.steals moved {steals.value - before}")
    if mask != np.asarray(expected[:n]).tolist():
        errors.append("a mask differs from the expected one")
    if sum(lanes) != n or host:
        errors.append(f"card lanes {lanes} (home, steal) for {n} sent, {host} on the host")
    if errors:
        fail(f"work stealing: {errors}")
    print(f"work stealing: {n} lanes in {n // STEAL_GROUP} groups, {stats['buckets']} buckets, "
          f"{stats['steals']} steals (pipeline.steals), card lanes home / steal {lanes}, masks as expected, "
          f"{secs:.2f} s; both backends are on one card, so this checks the accounting only", flush=True)
    return dict(stats=stats, lanes=lanes, seconds=secs)


WATCHDOG_LANES = 1024  # the forced watchdog check's flush size
WATCHDOG_CARD_FLUSHES = 32  # the watchdog's BASELINE_SAMPLES
WATCHDOG_HOST_FLUSHES = 8  # its REGRESSION_STREAK
WATCHDOG_HOST_CROSSOVER = 2 * WATCHDOG_LANES  # above the flush size: every flush to the host route


def watchdog_corpus(seed: int, lanes: int = WATCHDOG_LANES):
    """`lanes` distinct triples signed through OpenSSL by 16 keys, a seeded
    1/16 of them corrupted (`_corrupt_lanes`), and OpenSSL's mask of them.
    Returns (M, K, S, mask)."""
    import numpy as np

    rng = np.random.default_rng(seed + 24)
    n_keys = 16
    seeds = [bytes(row) for row in rng.integers(0, 256, (n_keys, 32), np.uint8)]
    M = [bytes(row) for row in rng.integers(0, 256, (lanes, 32), np.uint8)]
    K, S = [b""] * lanes, [b""] * lanes
    for j in range(n_keys):
        pk, sigs = _openssl_sign((seeds[j], M[j::n_keys]))
        K[j::n_keys], S[j::n_keys] = [pk] * len(sigs), sigs
    _corrupt_lanes(M, K, S, np.sort(rng.choice(lanes, max(1, lanes // 16), replace=False)))
    openssl = _openssl_verifier()
    if openssl is None:
        fail("the forced watchdog check needs OpenSSL (the cryptography wheel)")
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature

    return M, K, S, openssl(M, [PublicKey(k) for k in K], [Signature(x) for x in S])


def phase_watchdog(seed: int, device: str = "cuda", backend=None, lanes: int = WATCHDOG_LANES) -> dict:
    """The forced check of the anomaly watchdog's verify-regression trigger
    on the card: a traced `BatchVerificationService` over one `TorchBackend`
    (crossover 1) takes WATCHDOG_CARD_FLUSHES flushes of `lanes` real
    signatures on the card, then, its crossover raised above the flush size
    (WATCHDOG_HOST_CROSSOVER), WATCHDOG_HOST_FLUSHES of the same size on
    the host route (OpenSSL). The watchdog, reset before, must fire
    `verify_regression` exactly once and only in the second stretch, every
    mask must equal OpenSSL's, and on the card K2, K3, K1 and K4 must each
    launch once a card flush and nothing else. Prints both per-signature
    costs (the watchdog's baseline and trigger, and each stretch's median
    flush) and the launches. `backend` stands in for the card's in a CPU
    rehearsal."""
    import asyncio

    from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ops import _build
    from hotstuff_tpu_torch.utils import tracing

    M, K, S, want = watchdog_corpus(seed, lanes)
    pairs = [(PublicKey(k), Signature(x)) for k, x in zip(K, S)]
    own = backend is None
    if own:
        backend = TorchBackend(device=device, crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    flush = {"i": -1}
    fired, secs, masks = [], [], []

    def hook(reason: str, detail: dict) -> None:
        fired.append((flush["i"], reason, detail))

    async def drive():
        service = BatchVerificationService(backend, max_batch=lanes)
        # one flush before the watchdog's reset: the width's first dispatch
        await service.verify_group(M, pairs, source="mempool", dedup=False)
        stats0.update(backend.stats)
        tracing.WATCHDOG.reset()
        _build.reset_launches()
        tracing.WATCHDOG.add_dump_hook(hook)
        for i in range(WATCHDOG_CARD_FLUSHES + WATCHDOG_HOST_FLUSHES):
            if i == WATCHDOG_CARD_FLUSHES:
                launches["card"] = _build.launches()
                _build.reset_launches()
                backend.crossover = WATCHDOG_HOST_CROSSOVER
            flush["i"] = i
            t0 = time.perf_counter()
            masks.append(await service.verify_group(M, pairs, source="mempool", dedup=False))
            secs.append(time.perf_counter() - t0)
        launches["host"] = _build.launches()

    launches: dict = {}
    stats0: dict = {}
    was = tracing.enabled()
    tracing.enable(True)
    try:
        asyncio.run(drive())
        baseline = tracing.WATCHDOG._verify_baseline
    finally:
        tracing.WATCHDOG.remove_dump_hook(hook)
        tracing.WATCHDOG.reset()
        tracing.enable(was)
        if own:
            backend.close()
    card_n, host_n = WATCHDOG_CARD_FLUSHES, WATCHDOG_HOST_FLUSHES
    moved = {k: backend.stats[k] - stats0[k] for k in ("device_batches", "device_sigs", "host_batches", "host_sigs")}
    errors = []
    if [(i, r) for i, r, _ in fired] != [(card_n + host_n - 1, "verify_regression")]:
        errors.append(f"the watchdog fired {[(i, r) for i, r, _ in fired]} (flush, reason), not verify_regression "
                      f"once at flush {card_n + host_n - 1}, the last of the host stretch")
    if any(m != want for m in masks):
        errors.append(f"{sum(m != want for m in masks)} flushes' masks differ from OpenSSL's")
    if moved != {"device_batches": card_n, "device_sigs": card_n * lanes, "host_batches": host_n,
                 "host_sigs": host_n * lanes}:
        errors.append(f"routes moved {moved}, not {card_n} flushes on the card and {host_n} on the host")
    card_launched = {k: v for k, v in launches["card"].items() if v}
    host_launched = {k: v for k, v in launches["host"].items() if v}
    if device == "cuda" and (card_launched != {k: card_n for k in PACKED_KERNELS} or host_launched):
        errors.append(f"launched {card_launched} on the card stretch and {host_launched} on the host one, not "
                      f"K2, K3, K1 and K4 {card_n} times each and nothing")
    if errors:
        fail(f"forced watchdog check: {errors}")
    per_sig = [1e6 * statistics.median(secs[:card_n]) / lanes, 1e6 * statistics.median(secs[card_n:]) / lanes]
    detail = fired[0][2]
    print(f"forced watchdog check: {card_n} flushes of {lanes} lanes on the card then {host_n} on the "
          f"{backend.host_route} route (crossover {WATCHDOG_HOST_CROSSOVER}): verify_regression fired once, at "
          f"flush {fired[0][0]}; baseline {1e6 * baseline:.3f} us a signature, trigger "
          f"{1e6 * detail['per_sig_s']:.3f} us; each stretch's median flush {per_sig[0]:.3f} / {per_sig[1]:.3f} us a "
          f"signature; masks equal OpenSSL's ({want.count(False)} rejected lanes a flush); launches on the card "
          f"stretch {card_launched}, on the host stretch {host_launched}", flush=True)
    return dict(baseline_us=1e6 * baseline, trigger_us=1e6 * detail["per_sig_s"], median_us=per_sig,
                fired_at=fired[0][0], launches=launches)


REPLACES = {
    "ladder": "hotstuff_tpu/ops/pallas_ladder.py:144",
    "h_digits": "hotstuff_tpu/ops/sha512.py:448",
    "decompress_table": "hotstuff_tpu/ops/ed25519.py:561",
    "compress_eq": "hotstuff_tpu/ops/ed25519.py:591",
    "committee_ladder": "hotstuff_tpu/ops/ed25519.py:412",
    "h_digits_idx": "hotstuff_tpu/ops/ed25519.py:480",
    "reduce_mod_l": "hotstuff_tpu/ops/sha512.py:421",
    "g1_aggregate": "hotstuff_tpu/ops/bls.py:297",
    "g1_aggregate_affine": "hotstuff_tpu/ops/bls.py:389",
    "bls_mont_mul": "hotstuff_tpu/ops/bls.py:180",
    "bit_ladder": "hotstuff_tpu/ops/ed25519.py:599",
    "field12": "hotstuff_tpu/ops/field12.py:147",
    "field12_mul": "hotstuff_tpu/ops/field12.py:137",
    "field12_sub": "hotstuff_tpu/ops/field12.py:112",
    "field12_canonical": "hotstuff_tpu/ops/field12.py:184",
    "field_sqr_n": "tools/tune_device.py:96",
    "alu_chain": "tools/tune_device.py:35",
}


def tracing_ab(card: str) -> int:
    """`--tracing-ab`: phase 13 under each of TRACING_MODES, in the turns
    off, on, dump, dump, on, off on one card, so the cost of the flight
    recorder, the watchdog's feed and the dump shows against the swing
    between runs. Prints each run's and each mode's committed tx/s and
    blocks a second a node (the slowest node's), then one JSON object."""
    runs: dict[str, list[tuple[float, float]]] = {mode: [] for mode in TRACING_MODES}
    for turn, mode in enumerate(("off", "on", "dump", "dump", "on", "off")):
        r = phase_port_committee(REPO / ".chip_smoke" / f"tracing_ab_{turn}", tracing=mode)
        runs[mode].append((r["tx_per_s"], r["commits_per_s"]))
    for mode, pairs in runs.items():
        print(f"tracing {mode}: tx/s {[round(t, 3) for t, _ in pairs]}, blocks a second a node "
              f"{[round(b, 4) for _, b in pairs]}, means {sum(t for t, _ in pairs) / len(pairs):.3f} and "
              f"{sum(b for _, b in pairs) / len(pairs):.4f}", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"tracing_ab": runs}), flush=True)
    return 0


class Laps:
    """Wall seconds of each stretch of `main`, keyed by the phases it ran:
    `lap(label)` closes the stretch since the previous lap (or since the
    clock was made). `main` prints them on one line, so that a run's time
    splits by phase and two runs compare phase by phase."""

    def __init__(self) -> None:
        self.t = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def lap(self, label: str) -> None:
        now = time.perf_counter()
        self.seconds[label] = round(now - self.t, 1)
        self.t = now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multihost-worker", type=int, default=None, metavar="RANK", help=argparse.SUPPRESS)
    ap.add_argument("--multihost-dir", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tracing-ab", action="store_true",
                    help="build the kernels, then run only phase 13 under each of TRACING_MODES in turns "
                    "(off, on, dump, dump, on, off) and print each run's tx/s and blocks a second")
    args = ap.parse_args()

    import torch

    if args.multihost_worker is not None:  # phase 5c's rank: the phase checked the card and the package
        sys.path.insert(0, str(REPO))
        return multihost_worker(args.multihost_worker, args.multihost_dir)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "hotstuff_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the hotstuff_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    laps = Laps()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    phase_build()
    laps.lap("1 build")
    if args.tracing_ab:
        return tracing_ab(card)
    kernels = phase_compare(args.seed)
    kernels.update(phase_reduce_compare())
    laps.lap("2 compare")
    main_path = phase_main_path(args.seed)
    votes = committee_votes(args.seed)
    phase_staging(main_path["batch"], votes[2:6])
    phase_pipeline_ab(main_path["batch"])
    laps.lap("3-4 main path, staging, pipeline A/B")
    committee_path = phase_committee_path(votes)
    committee_kernels = phase_committee_compare(args.seed, committee_path["table_keys"])
    laps.lap("5 committee path and compare")
    mesh = phase_mesh(main_path["batch"], committee_path, main_path["launches"], kernels, committee_kernels, card)
    laps.lap("mesh")
    multihost = phase_multihost(main_path["batch"], committee_path, card)
    laps.lap("5c multihost")

    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ops import _build

    sidecar_backend = TorchBackend(device="cuda", crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    sidecar = phase_sidecar(args.seed, sidecar_backend, committee_path, main_path["sigs_per_s"], card)
    laps.lap("6 sidecar")
    committee_run = phase_committee_run(sidecar_backend, committee_path["qcs"], REPO / ".chip_smoke" / "committee")
    laps.lap("7 reference committee")
    print(f"sidecar pipeline: {_pipeline_line(sidecar_backend._verifier)}", flush=True)
    off_path = bls_off_path_errors({
        "main path": main_path["launches"], "committee path": committee_path["launches"],
        "sidecar": sidecar["launches"], "committee run": committee_run["launches"],
        **{f"mesh {label} {leg}": m[leg] for label, m in mesh["meshes"].items()
           for leg in ("launches", "committee_launches")},
    })
    if off_path:
        fail(f"BLS kernels launched in phases 3-7: {off_path}")
    bls_path = phase_bls(args.seed)
    laps.lap("8 BLS")
    k7_off = k7_off_path_errors({
        "main path": main_path["launches"], "committee path": committee_path["launches"],
        "sidecar": sidecar["launches"], "committee run": committee_run["launches"], "BLS": bls_path["launches"],
        "since the BLS phase's reset": {"bit_ladder": _build.KERNELS["bit_ladder"].launches},
        **{f"mesh {label} {leg}": m[leg] for label, m in mesh["meshes"].items()
           for leg in ("launches", "committee_launches")},
    })
    if k7_off:
        fail(f"K7 launched in phases 2-8: {k7_off}")
    f32 = phase_f32(args.seed, main_path["batch"])
    laps.lap("9 f32")
    print(f"f32 path sigs/s {f32['rates']} beside phase 3's packed path {main_path['sigs_per_s']:.1f}", flush=True)
    since_f32 = _build.launches()
    tuning_off = off_path_errors({
        "main path": main_path["launches"], "committee path": committee_path["launches"],
        "sidecar": sidecar["launches"], "committee run": committee_run["launches"], "BLS": bls_path["launches"],
        **{f"f32 {k}": d for k, d in f32["leg_launches"].items()},
        "since phase 9's last reset": since_f32,
        **{f"mesh {label} {leg}": m[leg] for label, m in mesh["meshes"].items()
           for leg in ("launches", "committee_launches")},
    }, TUNING_KERNELS)
    if tuning_off:
        fail(f"K8 or the tuning tool's kernels launched in phases 2-9: {tuning_off}")
    tuning = phase_field12(args.seed)
    field_launches = _build.launches()
    phase_wide_compare(args.seed)
    tool_launches = phase_tune()
    laps.lap("10 field12, wide compare, tuning")
    bls_late = bls_off_path_errors({
        **{f"f32 {k}": d for k, d in f32["leg_launches"].items()}, "since phase 9's last reset": since_f32,
        "phase 10 field12": field_launches, "phase 10 wide compare": _build.launches(), "tuning tool": tool_launches,
    })
    if bls_late:
        fail(f"BLS kernels launched in phases 9-10: {bls_late}")
    bench_runs = phase_bench()
    laps.lap("11 bench")
    bench_runs.update(phase_bench_legs(args.seed))
    laps.lap("12 bench legs")
    bench_launches = {label: r["launches"] for label, r in bench_runs.items()}
    port_committee = phase_port_committee(REPO / ".chip_smoke" / "port_committee")
    laps.lap("13 port committee")
    phase_latch_probe()
    phase_roofline(main_path["sigs_per_s"], len(committee_path["table_keys"]), {**kernels, **committee_kernels})
    phase_steal(main_path["batch"])
    phase_watchdog(args.seed)
    laps.lap("14 latch_probe, roofline, stealing, watchdog")
    print(f"phase 14 (latch_probe, roofline, work stealing, watchdog): "
          f"{laps.seconds['14 latch_probe, roofline, stealing, watchdog']:.1f} s", flush=True)
    port_ingress = phase_port_ingress(REPO / ".chip_smoke" / "port_ingress")
    laps.lap("15 port ingress")
    port_deploy = phase_port_deploy(REPO / ".chip_smoke" / "port_deploy")
    laps.lap("16 port deploy")
    node_launches = lambda name: {node: d.get(name, 0) for node, d in port_committee["launches"].items()}  # noqa: E731
    ingress_launches = lambda name: {node: d.get(name, 0) for node, d in port_ingress["launches"].items()}  # noqa: E731
    multihost_launches = lambda name: {rank: d.get(name, 0) for rank, d in multihost["launches"].items()}  # noqa: E731

    rows = []
    for results, path in ((kernels, main_path), (committee_kernels, committee_path)):
        for name, res in results.items():
            rows.append(dict(
                name=name, route="cuda",
                source=f"hotstuff_tpu_torch/ops/csrc/{_build.KERNELS[name].source}.cu",
                replaces=REPLACES[name], launches=path["launches"][name],
                sidecar_launches=sidecar["launches"][name],
                bench_launches={label: n[name] for label, n in bench_launches.items()},
                mesh_launches={label: m["launches"][name] + m["committee_launches"][name]
                               for label, m in mesh["meshes"].items()},
                node_launches=node_launches(name), ingress_node_launches=ingress_launches(name),
                multihost_launches=multihost_launches(name),
                deploy_launches=port_deploy["launches"].get(name, 0),
                matches_plain=res["max_abs_err"] == 0, max_abs_err=res["max_abs_err"],
                ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=None,
            ))
    # The BLS kernels run on no ed25519 path: their launches are phase 8's
    # (the affine entry's; the fold alone and the product are test entries).
    for name, res in bls_path["kernels"].items():
        rows.append(dict(
            name=name, route="cuda",
            source=f"hotstuff_tpu_torch/ops/csrc/{_build.KERNELS[name].source}.cu",
            replaces=REPLACES[name], launches=bls_path["launches"][name],
            sidecar_launches=sidecar["launches"][name],
            bench_launches={label: n[name] for label, n in bench_launches.items()},
            mesh_launches={label: m["launches"][name] + m["committee_launches"][name]
                           for label, m in mesh["meshes"].items()},
            node_launches=node_launches(name), ingress_node_launches=ingress_launches(name),
            multihost_launches=multihost_launches(name),
            deploy_launches=port_deploy["launches"].get(name, 0),
            matches_plain=res["max_abs_err"] == 0, max_abs_err=res["max_abs_err"],
            ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=None, **res.get("extra", {}),
        ))
    res = f32["kernel"]
    rows.append(dict(
        name="bit_ladder", route="cuda", source="hotstuff_tpu_torch/ops/csrc/bit_ladder.cu",
        replaces=REPLACES["bit_ladder"], launches=f32["launches"]["bit_ladder"],
        sidecar_launches=sidecar["launches"]["bit_ladder"],
        bench_launches={label: n["bit_ladder"] for label, n in bench_launches.items()},
        mesh_launches=f32["mesh_launches"],  # phase 9's ShardedEd25519TorchVerifier(packed=False) runs
        node_launches=node_launches("bit_ladder"), ingress_node_launches=ingress_launches("bit_ladder"),
        multihost_launches=multihost_launches("bit_ladder"),
        deploy_launches=port_deploy["launches"].get("bit_ladder", 0),
        matches_plain=res["max_abs_err"] == 0, max_abs_err=res["max_abs_err"],
        ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
        bound_by=res["bound_by"], library_ms=None, **res["extra"],
    ))
    # K8 and the tool's two kernels: launches are the tool's run (phase 10);
    # `compare_launches` those of phase 10's comparisons and times.
    for name, res in tuning.items():
        rows.append(dict(
            name=name, route="cuda",
            source=f"hotstuff_tpu_torch/ops/csrc/{_build.KERNELS[name].source}.cu",
            replaces=REPLACES[name], launches=tool_launches.get(name, 0),
            sidecar_launches=sidecar["launches"][name],
            bench_launches={label: n[name] for label, n in bench_launches.items()},
            mesh_launches={label: m["launches"][name] + m["committee_launches"][name]
                           for label, m in mesh["meshes"].items()},
            node_launches=node_launches(name), ingress_node_launches=ingress_launches(name),
            multihost_launches=multihost_launches(name),
            deploy_launches=port_deploy["launches"].get(name, 0),
            matches_plain=res["max_abs_err"] == 0, max_abs_err=res["max_abs_err"],
            ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=None, **res["extra"],
        ))
    print(f"phase seconds: {json.dumps(laps.seconds)} (card line and start-up in the first)", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
