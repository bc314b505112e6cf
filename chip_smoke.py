#!/usr/bin/env python3
"""On-card smoke test of the zorak_tpu_torch port (one NVIDIA GPU, Hopper).

    python3 chip_smoke.py

    python3 chip_smoke.py --phases jsfx      # the JSFX phases alone
    python3 chip_smoke.py --phases batch     # the batch phases alone
    python3 chip_smoke.py --phases spectral  # the spectral phase alone
    python3 chip_smoke.py --phases coupled   # the coupled @block alone
    python3 chip_smoke.py --phases gated,hop # the gated and hop regimes
    python3 chip_smoke.py --phases planner   # ring cycles, dynamic delays, rand()
    python3 chip_smoke.py --phases devexec   # the sequential executor
    python3 chip_smoke.py --phases tooling   # bench, help, new-plugin, dumps
    python3 chip_smoke.py --phases graph     # the render graph's lockstep
    python3 chip_smoke.py --phases services  # the host services (K11, K10)
    python3 chip_smoke.py --phases faust     # K1, K9, VAR, the Faust batches

Phases, in order; any failure raises and the script exits non-zero
without printing a result (`--phases` takes any of `jsfx`, `batch`,
`spectral`, `coupled`, `gated`, `hop`, `planner`, `devexec`, `tooling`,
`graph`, `services` and `faust`, all twelve by default;
device and build always run; `k4sweep` is described at the end):

1. device   the card's name and power limit (nvidia-smi);
2. build    every CUDA kernel of the paths, from csrc/ in this checkout,
            one nvcc a source, all started together (the generated
            scan-group kernels are built in phase 3, all together too);
3. kernels (jsfx)  the linear-recurrence scan (K2, a chunked affine
            scan) against `linrec_chunked`, the NumPy mirror of its
            order (equal, every NaN one value), and within 1e-9 x max|z|
            of the sequential loop and of its plain doubling ladder
            (scalar and per-sample a; k in 1, 2, 8; L in 1, 7, 4,096,
            131,072; z0 != 0, a = 0, NaN in b; |a| > 1 with overflow,
            integrators on integer counters, exact; L in 100, 1,000,
            131,071), its time at the main shape beside one chunk (a
            thread a row), the ladder's, its bounds, a one-thread chain
            probe and a sweep over the chunk.  The ring tap sum (K3, a
            window staged in shared memory, the ring read in place,
            sibling chains in one launch) against its plain fold,
            bit-identical, at 16, 192 and 300 taps, delays 0 to mod,
            history alone, cursor starts 0, mod - 1 and the middle, L =
            131,072, a short remainder and 1, scalar, stream and 0-d
            inits, batches of five chains of different tables, a chain
            cut into windows, every tile, and the earlier design (a
            thread a sample); at the two delay networks' planned
            launches, the pair in one launch beside one chain, two
            launches, the earlier design and the buffers the emitter
            joined before, the plain fold's time, a dense FIR
            convolution's (the library call), a sweep over the tile and
            three floors (operations at two roundings, on-chip reads,
            bytes).  The
            scan-group kernels (K4, a speculate and a fix-up kernel),
            generated from each plugin's own step list: eight bodies
            (followers, a coupled pair, a nonlinear recurrence, a peak
            hold fed from a delay, a wrap loop, a sin in the loop)
            against the plain Python loop on the same inputs at L in 1,
            7, 4,096, 131,072, non-zero start carries, with and without
            NaN and -0.0 in the externals, at the default chunk and
            warm-up and at a small one (many chunks re-run):
            bit-identical, every NaN counted as one value, or within
            1e-8 for the body that calls the device's libm; at L =
            131,072 its time and re-run steps on noise and on
            program-like material beside the walk in series (one chunk),
            the plain loop's, a one-thread chain probe of the same body,
            the chunked chain bound, the bytes bound, each body's merge
            step and a launch-per-sample estimate; the follower after a
            burst into exact silence (bit-identical; launches that
            re-walk and launches in series take turns); then every
            operation of csrc/scan_ops.cuh on every pair of a grid of
            edge values against the scalar semantics, bit for bit (the
            libm calls within 4 ulp), as one chunk;
4. main (jsfx)  the in-repo delay network, its 192-tap widening and a
            cross-fed network (the right ring written from the left sum)
            through PluginInstance.render on 60 s of 48 kHz stereo noise
            at the default segment length: engine torch-vector, K2 and
            K3 launch counts, finite output, timing, a torch.profiler
            pass (device events a segment), the first second against
            the port's CPU render, the
            first 4,800 samples against the Python golden and the
            carries after 10 s against the CPU render's within 1e-8;
            then, the same way, two plugins with sequential scan groups
            (a follower that feeds both channels, and two independent
            envelopes): engine torch-vector, K4 launches = levels x
            segments, K4's re-run steps; each whole 60 s render (the
            fallback network reported, not held: it misses its own
            golden) against the native C golden through
            `null_test_plugin(golden="native")`: audio within 1e-5, vars
            and heap within 1e-8 at the end; then the CLI's `verify`
            (native golden, an export bundle) on a one-entry catalog;
4a. batch   K3 and K4 with a files axis (1, 3 and 8 files, other data
            a file, NaN in one, for K4 the last file's burst into
            silence) against their plain versions and against each
            file's own launch, bit for bit, the K4 re-run steps and
            flags of a batch those of its files alone; then the JSFX
            batch path, BatchRenderer on 8 files x 60 s of stereo noise
            at the bench's segment ((1 << 15) * 11, 8 segments) through
            the 192-tap widening, the cross-fed network and the two
            scan-group plugins: every file torch.equal to its solo
            render on the card, K2, K3 and K4 launched exactly as often
            as for one file, the K2, K3 and K4 launches of the middle
            segment held bit for bit to their plain versions on the same
            inputs (linrec_chunked, ring_tap_sum_reference, and
            scan_group_plain on the first and last file's first 16,384
            steps), times beside one file's, a profiler pass;
            the catalog functions (catalog_batch_render,
            catalog_stacked_render) on a temporary catalog of two Faust
            modules and three JSFX plugins, CUDA against CPU, K1 to K4
            launched; then zorak_tpu_torch/bench.py's config 1:
            ddt_offline_render_rtx at both segment lengths and
            ddt_batched;
4b. spectral  the STFT framing (K7a), overlap-add (K7b) and gate gain
            (K7c) kernels and the partition MAC (K8) against their plain
            versions, bit-identical (every NaN one value), at odd shapes
            (1 and 3 lanes, a hop that does not divide the size, T <
            size, T not a multiple of the part size, an IR under one
            partition, NaN, inf and -0.0 in the inputs; for K8 the edges
            of its walk, every tile it is built for, scale 1 and 2^-12)
            and at the bench's (32 lanes x 20 s, size 2,048, hop 512; a
            131,072-tap IR at part size 2,048; K8's every tile, irfft's
            1/N, and the earlier design); the convolution with 1/N folded
            into K8 against irfft's own 1/N, bit for bit; stft_process,
            spectral_gate and partitioned_convolve on the card against
            the port's CPU render (the convolution also against scipy's
            fftconvolve in f64) at the odd shapes and, on two lanes, at
            the bench's; each kernel's time beside its bound, its plain
            version's and the library call's (Tensor.unfold x window for
            K7a, F.fold x 1/wsum for K7b, a grouped complex conv1d with
            TF32 off for K8; K7c has none); K8's tiles swept, its design
            and the earlier one timed in turns beside the SM clock under load;
            then the three bench sections of zorak_tpu_torch/bench.py as
            a user calls them: each kernel's launches a section call,
            and the stft2048_overlap_add_rtx,
            restoration_spectral_gate_rtx and
            partitioned_convolution_131072tap_rtx figures; a profiler
            pass a pipeline (the convolution's must hold K8 and no
            multiply pass);
4c. coupled  the audio-coupled @block of builtin_plugins'
            spectral_tilt_leveler(2048) (a Hann-windowed fft_real of a
            2,048-cell ring every block): K10 (block_section, generated
            CUDA C from lowering/devgen.py and csrc/block_ops.cuh: the
            window loop, fft_real and fft_permute on every thread of a
            file's block, the band loop and the scalar updates on thread
            0), its phases checked, built beside its probe build (the
            earlier design, thread 0 alone, and the probes) and the
            thread sweep's builds (128 to 1,024), all nvcc runs together;
            PluginInstance.render on 60 s of stereo: engine torch-vector,
            K10 and K3 launched once a block, K2 a fixed number of times a
            block, no block loop run on thread 0 (K10's counter), the time
            after a 1 s warm-up render with the spread of two more
            renders, the render through K5 torch.equal to the eager
            step's (whose K10 inputs are recorded at two blocks), the
            whole render (audio,
            vars and heap after the writeback) held to the native golden,
            the golden's own time; on the inputs K10 met at the first and
            the middle block of renders of 1 file (60 s) and of 8 (60 s), K10
            against the earlier design bit for bit (vars, the heap with
            the FFT buffer, the exchanges, control row, MIDI out) and
            against its plain version (the exchanges and the heap outside
            the FFT buffer bit for bit, the FFT buffer, vars and control
            row within FFT_TOL_REL x the heap's largest magnitude); the
            two designs timed in turns (earlier, K10, K10, earlier) for 1
            and 8 files; the thread sweep; the probes: the sections on
            one thread, thread 0's ordered code alone, fft_real on one
            thread and in block form beside torch.fft.rfft, a dependent
            f64 add and a barrier (the chain bound); the idle share and
            K10's share of a traced 10 s render; K5 held to the eager step
            on 10 s and on 8 files x 2 s; a batch of 8 files x 60 s
            beside one file's time, and each file of an 8-file batch of
            2 s torch.equal to its solo render;
4d. gated   builtin_plugins' gated_fdn_tank(8, 8192) (eight rings whose
            shared cursor advances only where the input level passes a
            threshold, taps 1,500 to 4,000 cells behind it, one of them
            from the control, a one-pole in the gate's branch, a gated
            rand() dither) through PluginInstance.render on 60 s of
            stereo (K5's replays; 10 s while the host paced it):
            engine torch-vector, the segment length the plan cut
            (1,024) and the segments, K2's launches and K6's and K3b's
            (GATED_K6_PER_SEGMENT: K6a, K6b, K6c and the eight taps'
            gathers a segment, csrc/gated_index.cu), the whole render
            (audio, vars and heap) held to the native golden, its first
            second to the port's CPU render, a traced 1 s render of the
            eager step with K6's share (the kernels inside the emitter's
            zorak.k6 ranges) of the busy device time, K5 held to
            the eager step on 5 s; the masked-loop ladder on
            10 s of stereo from a guessed bound of 2 (the rebuilds
            counted, the render held to the native golden); 8 files of
            2 s through BatchRenderer, each torch.equal to its solo
            render; K6's and the taps' launches of a middle segment of 1
            and of 8 files held bit for bit to their plain versions on
            the same inputs, each timed (20 launches in a CUDA graph)
            beside its plain version and its bound;
4e. hop     builtin_plugins' hop_convolver(1024, 8) (a partitioned
            convolver whose FFT work fires every 1,024 samples from
            inside @sample) through PluginInstance.render on 60 s of
            stereo: engine torch-vector, dispatch graph (a hop's step,
            its segment then K10, replayed by K5), K10 launched once a
            hop by the replays' counts with no block loop or copy on
            thread 0, the render torch.equal to the eager loop's over
            its first half and held to the native golden; K10's phases
            printed (process(), called as a statement, in place: its
            copies, transforms and counted while loops across the block,
            the delay line's shift and the partition loop as loops every
            thread follows); K10 at the first and the middle hop bit for
            bit to its earlier one-thread design (a probe build) and
            against its plain version (the scalars and vars bit for bit,
            heap and rings within FFT_TOL_REL), the two designs timed in
            turns by CUDA events beside the chain bound (the barriers
            the host form counts, at the probes' latencies) and the
            bytes bound; K5 held to the eager step on 10 s (`k5_held`);
            8 files of 2 s through BatchRenderer, each torch.equal to
            its solo render;
4p. planner  the planner's paths at the CPU tests' sizes on the card
            (tests/test_torch_planner_paths.py): the time-blocked ring
            cycles (their segment lengths, 256 and 512), the dynamic
            delays, ungated and gated rand() and the sysex payload from
            @block, each held to the native golden (audio, vars and heap)
            and to the port's CPU render; the gated branch's rand()
            streamed over two resumed renders; the sub-block cycle on
            devexec (K11) against the golden.  Then two stand-ins, 60 s
            of stereo each through PluginInstance.render:
            modulated_delay_chorus(3, 4096) (per-voice sine LFOs, twelve
            dynamic ring reads; engine torch-vector): device ms after a
            warm-up, K3b's launches (twelve a segment), a traced 1 s
            with the idle share and K3b's share (the kernels inside the
            emitter's zorak.k3b ranges) of the busy time, the render
            held to the native golden, K3b's twelve launches of a
            middle segment held bit for bit to the plain version and
            timed; tpdf_dither(16) (four ungated rand() draws a
            sample): the first fresh render (the draw cache's miss, the
            host's MT19937 seconds and the matrix's upload) and the
            second (the hit) by CUDA events and wall clock, the hit's
            audio torch.equal to the miss's, the generator state equal,
            the cached matrix unchanged, the render held to the native
            golden;
4f. devexec  the sequential device executor: K11 (device_exec, CUDA C
            generated from a plugin's @block, @slider and @sample by
            lowering/devgen.py with the reduced heap and the staged draw
            pool of csrc/block_ops.cuh; a file a CUDA block of one warp,
            its var row and its heap's first 4,096 cells staged in
            shared memory, lane 0 running the render) built for
            builtin_plugins' grain_texture(16, 131072) (the stand-in for
            the catalog's Texture: grain records through an order table,
            ring reads clamped by a block-rate fill level, rand() in
            @block and @sample), for the gmem stand-in
            scene_voice_panner(8, 256) and for the cases of
            tests/test_devexec.py that need no host service, the
            page-edge case and gmem with a lone instance's bus, all nvcc
            runs together, with the probe build (registers, stack frames
            and spills printed; the registers, shared memory a block and
            blocks an SM the card reports; the counts of LDG, STG, LDS,
            STS, LDL, STL and CALL in zx_kernel's SASS, the listing in
            chiprun_out/devexec_sass.txt: no local memory but the libm's
            own, no call to a section); K11 against its plain version on
            1 and 8 files of 1,100 samples with note-ons (bit for bit, but
            the cells and slots the stand-in's sin reaches within 1e-8 and
            the audio within one f32 ulp, the differing ones named); the
            gmem and lone-bus case on 3 files bit for bit to its plain
            version (the high-water slot aside); the cases against the
            native golden, gmem included; PluginInstance.render of the
            stand-in on 60 s of stereo with a note-on every 0.5 s: engine
            torch-devexec, K11 launched 1 + the heap ladder's replays
            (4,096 -> 262,144 -> 524,288 cells), each launch timed, the
            draws against the pool, the whole render (audio, vars, heap)
            held to the native golden and the golden's host seconds; the
            gmem stand-in the same way on 60 s of stereo (engine
            torch-devexec, its launches timed, audio, vars, heap and gmem
            held to the native golden, the golden's seconds); 8
            files x 2 s through render_files, each torch.equal to its solo
            render; audio-s per s at 1 (the render's launch), 8, 64 and
            256 files (10 s each) beside the golden's, and where the card
            overtakes it; the section probe (the text built again with
            ZX_PROBE: clock64() around each section call and the sample
            loop's I/O, 1 file x 10 s, the shares of the render's
            cycles); the latency probe's links (a dependent f64 add, sin,
            shared, L1 and L2 load, a heap read through K11's accessor);
            K11's chain bound from the add and the @sample syntax tree
            (`device_exec.sample_chain_ops`), and the chain priced with
            its loads and its sin;
4t. tooling  the CLI's new-plugin into a temporary catalog, the gmem
            stand-in and grain_texture as its leaves, help, bench
            --seconds 10 --json on the card (a vector and a devexec
            entry), and utils.dumps.dump_stages of a vector, a coupled
            and a devexec kernel with nvcc's register and spill lines;
4g. graph  the render graph (runtime/graph.py): 4 instances of
            builtin_plugins.crossmix_declutter (slots 0 to 3: a shared
            gmem segment, a broadcast channel drained with a while loop,
            a coupled @block) on 60 s of seeded stereo noise each at block
            512, all four torch-lockstep: K10 with the lockstep's staging
            (the bus's prologue and epilogue, the segment in place)
            launched 22,500 times, each node's audio within AUDIO_EPS and
            its vars and the segment's cells within SCALAR_EPS of the
            all-shadow graph through the native golden, the ring's tail,
            the cursors, zero drops and zero overflow; K10 at the first and
            middle block of every member bit for bit against its plain
            version (vars, heap with its queues, OUT table and gmem window,
            the segment, the ring window, its count and cursors); the
            render's seconds and node-audio-s per s beside the golden
            graph's host seconds, K10's time a launch beside its bound
            (the window, queues, OUT table and segment bytes; thread 0's
            chain at a dependent add's latency), device events and host ms
            a block, the idle share of a traced second; then a 3-node
            graph (the IPC-probe shape) of 2 s at block 64: a coupled
            lockstep pair beside an uncoupled torch-vector node on another
            bus (its @block on the host in lockstep), held to the native
            golden graph;
4s. services  the host services: builtin_plugins.pool_sampler(8, 16)
            over a sample pool its @init builds from file slot 0 (16
            stereo entries of 10 s made from the seed, four at 44.1 kHz
            resampled by the pool: 61.4 MB of f32 on the card) through
            PluginInstance.render on 60 s of stereo: engine
            torch-devexec, one K11 launch, the pool's tables staged once
            (and once for 8 files and their solo renders), every entry
            read; K11 bit for bit to its plain version (the Python golden
            answering the pool through the EngineHost) at the first and
            the middle block; the render (audio, vars and heap) held to
            the native golden, which a child process renders from the
            start of the script (its pool calls are Python calls:
            minutes on one core); 8 files x 10 s through render_files,
            each torch.equal to its solo launch; K11's bytes and chain
            bounds; then slot_table_leveler(65536), 60 s of
            stereo on K10 (its @block's load from file slot 0 folded into
            the text as a copy from the file table): 5,625 launches, the
            render held to the native golden, K10 bit for bit to its
            plain version at the reload block and a steady one, each
            timed;
5. kernels (faust)  the switching scan (K1) must be bit-identical
            (integer views equal), in f64 and f32: at modest shapes, at
            the batch and main paths' shapes (its one-chunk case too),
            with a small chunk and warm-up at T from 1 to 20,000 (many
            chunks, re-runs), and on inputs where trajectories do not
            merge (a burst into exact silence, also at T = 60,000 with
            the default chunk and warm-up), constant input, -0.0 and NaN.
            Its time at the main shape beside the one-chunk case's (a
            thread per lane) and the worst case's, re-run steps, and the
            chain bound from a one-thread probe.  The plain loop runs a
            tenth of the main length, in f64 and in f32 (it takes 70 to
            110 us a step); at the main length K1 at its defaults is held
            bit for bit to K1 as one chunk: the main shape in f64 and
            f32, the worst case and every input the VAR and RED renders
            below give K1;
            Then K9 (csrc/dsp_scan.cu: the chunked affine, max-plus and
            biquad scans, the LCG's jump-ahead noise) against its host
            form (the source compiled with g++) bit for bit, every NaN
            one value, and its plain doubling ladder within 1e-9 x
            max|y| with NaN and inf in the same places: T in 1, 127,
            128, 129, 4,097 and two carry tiles, rows 1, 3 and 8,
            non-zero z0 and s0, a per-sample pole, NaN and inf in x, the
            VAR biquads' coefficients; the noise bit for bit at four
            seeds across the grid's edges and at the main length; each
            kernel's time at the main length (a CUDA graph of 20 calls)
            beside its bytes bound and its plain ladder's time;
6. main (faust)  VAR on 60 s of 48 kHz stereo noise (seeded numpy) on CUDA:
            launch counts (K1 once, K9 8 + 5 + 2), re-run steps, finite
            output, timing, and the
            first second against the port's CPU render at the audio
            epsilon; then VAR on 60 s of program-like material (noise
            with a silent lead-in, silent gaps and a fade-out): time and
            re-run steps;
7. batch (faust)  all five Faust modules through FaustBatchRenderer on
            8 files of 10 s each (K1 and K9 launches), the first second
            of each file against
            the CPU render and file 0's first 4,800 samples against the
            module's NumPy golden (models/faust_golden.py); each file of
            VAR's batch torch.equal to its solo render;
then one `kernels` JSON line (K9's entries, `affine_scan`, `maxplus_scan`,
`biquad_scan` and `lcg_noise`, carry `launches_var` and `launches_batch`,
their launches in the VAR render and in the five batch renders, and
`launches` their sum; beside K1's `bound_ms`: `chain_ms`, the chain
bound of T steps in one thread, `chunk_chain_ms`, that of the chunked
scan's warmup + chunk steps, `earlier_ms`, the one-chunk time, the
worst case, and the program-like render's re-run steps; K11 the
render's launches, the golden's seconds, audio-s per s by files; K2, K3
and K4
carry `launches_batched`, their launches in the batch phase's render of 8
files, K2 `launches_gated`, its launches in the gated render; K6
(`gated_index`: K6a, K6b, K6c and the tank's gathers, a segment's
launches timed at one file) its launches and times by kernel, K3b
(`dyn_ring_read`, a launch at the chorus's shape) `launches_gated` and
the tank's times; K10 the
hop section's `hop_ms`, `hop_launches` and the rest, and the graph's
`launches_graph`, `graph_ms_a_launch` and the rest; K11 and K10 the
services phase's `services_*` fields: the sampler's and the leveler's
launches, times, bounds and goldens) and, last, the device JSON line.  Each phase prints the seconds
it took.

    python3 chip_smoke.py --phases k4sweep

runs neither path: it times K4 at L = 131,072 with 2 to 32 samples held
in registers at once, at five pairs of chunk and warm-up beside the
walk in series, and with the speculate kernel loading the externals the
other way (staged through shared memory, or in register blocks), for the
K4 bodies with one, two and three external streams, each held bit for
bit to the default's output first.

Imports nothing of JAX or of the JAX package `zorak_tpu`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np

SR = 48000.0
MAIN_T = 2_880_000          # 60 s at 48 kHz
BATCH_FILES, BATCH_T = 8, 480_000
SEG_L = 1 << 17             # the JSFX engine's default segment length
SEED = 20261016

# an attack/release follower: its pole depends on its state, so the
# planner makes it a sequential scan group
SCAN_GROUP_SRC = """\
desc:attack/release follower
@init
env = 0; up = 0.9; dn = 0.999;
@sample
x = abs(spl0);
env = x > env ? x + (env - x)*up : x + (env - x)*dn;
spl0 = env; spl1 = env;
"""

# two independent attack/release followers, one a channel: one DAG level,
# two components, so K4 walks them in two blocks, one thread each
STEREO_FOLLOWERS_SRC = """\
desc:two attack/release followers
@init
up = 0.9; dn = 0.999;
@sample
x0 = abs(spl0); x1 = abs(spl1);
e0 = x0 > e0 ? x0 + (e0 - x0)*up : x0 + (e0 - x0)*dn;
e1 = x1 > e1 ? x1 + (e1 - x1)*up : x1 + (e1 - x1)*dn;
spl0 = spl0*(1 - 0.5*e0); spl1 = spl1*(1 - 0.5*e1);
"""

# scan-group bodies held to the plain loop: name -> (source, channels).
# The linear pair `a2 = 0.95*b + ...; b = 0.9*a2 + ...` folds into one
# linear recurrence (K2's), so the pair here is coupled through a select.
K4_BODIES = {
    "follower": (SCAN_GROUP_SRC, 2),
    "stereo_followers": (STEREO_FOLLOWERS_SRC, 2),
    "attack_release_envelope": (
        "@init\na_att = 0.6; a_rel = 0.999;\n@sample\nr = abs(spl0);\n"
        "env = r > env ? a_att*env + (1-a_att)*r : a_rel*env + (1-a_rel)*r;\n"
        "spl0 = env;\n", 1),
    "coupled_pair": (
        "@sample\nx = abs(spl0);\n"
        "fast = x > slow ? x : fast*0.9 + slow*0.1;\n"
        "slow = fast > slow ? slow + (fast - slow)*0.01 : slow*0.9995;\n"
        "spl0 = fast - slow;\n", 1),
    "nonlinear_self_recurrence": (
        "@sample\nz = z*0.9 + z*z*0.01 + spl0*0.1;\nspl0 = z;\n", 1),
    "group_feeding_from_vectorized_delay": (
        "@init\nMASK = 511; d = 100;\n@sample\nbuf[w & MASK] = spl0;\n"
        "late = buf[(w - d) & MASK];\n"
        "pk = abs(late) > pk ? abs(late) : pk*0.995;\n"
        "spl0 = late * (1 - 0.5*pk);\nw += 1;\n", 1),
    "wrap_feeding_recurrence": (
        "@sample\nph += 0.37 + spl0;\nwhile (ph > 1) ( ph -= 2; );\n"
        "spl0 = ph * 0.5;\n", 1),
    "transcendental_in_the_loop": (
        "@sample\nz = sin(z*0.9 + spl0);\nspl0 = z;\n", 1),
}
# the sweep over register block sizes: one, two and three externals, one
# and two components, a data-dependent loop
K4_SWEEP_BODIES = ("follower", "stereo_followers", "attack_release_envelope",
                   "wrap_feeding_recurrence")
K4_SWEEP_UNROLLS = (2, 4, 8, 16, 32)
# (chunk, warm-up) pairs the sweep times beside the walk in series
K4_SWEEP_PLANS = ((1024, 49152), (1024, 16384), (256, 16384), (4096, 16384),
                  (1024, 8192))
K4_LIBM_TOL = 1e-8     # the device's sin is 1 to 2 ulp from glibc's
K4_LIBM_ULPS = 4.0     # one libm call on the card against glibc's
K4_EDGE_VALUES = [
    0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 0.3, -0.999, 2.5, -2.5, 3.0, 7.0, -7.0,
    31.0, 32.0, 33.0, -33.0, 255.75, 4.9e-324, -4.9e-324, 1e-310,
    2.2250738585072014e-308, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 1,
    2.0 ** 31 + 0.5, -(2.0 ** 31) - 1, 2.0 ** 32, 2.0 ** 32 + 5,
    -(2.0 ** 32) - 3, 2.0 ** 53, 2.0 ** 62, -(2.0 ** 62), 1.5 * 2.0 ** 62,
    -1.5 * 2.0 ** 62, 2.0 ** 63, -(2.0 ** 63), 1e300, -1e300, 3.5e38,
    float("inf"), float("-inf"), float("nan"),
]
K1_PLAIN_T = 288_000   # K1's plain Python loop, f64 and f32: a tenth of MAIN_T
K4_BATCH_HELD_T = 16_384  # K4's plain loop at the batch's shapes: its steps
FAUST_GOLDEN_T = 4_800    # the Faust NumPy goldens (a Python loop a sample)

# the host services: builtin_plugins.pool_sampler over 16 stereo entries
# of 10 s (16 x 480,000 frames x 2 channels x 4 B = 61.4 MB of f32 on the
# card after the pool's resampling to 48 kHz), and slot_table_leveler's
# 65,536-value table
SERVICES_VOICES, SERVICES_SAMPLES, SERVICES_SAMPLE_S = 8, 16, 10.0
SERVICES_TABLE = 65_536
SERVICES_FILES, SERVICES_FILES_T = 8, 480_000    # 8 files x 10 s

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}   # outside tensor cores
# a DMUL or a DADD issues at the DFMA instruction rate, half the f64 peak
F64_INSTR_PER_S = PEAK_OPS_PER_S["float64"] / 2
SMEM_BYTES_PER_CLK = 128   # shared memory / L1 of one SM (Hopper)
SCAN_OPS_PER_STEP = 5   # compare, select, subtract, multiply, add
# dspkit stages one VAR render runs (zorak_tpu_torch/models/faustmods.py,
# VAR.forward): two noise streams, eight biquads, five one-poles, one scan
VAR_STAGES = {"lcg_noise": 2, "biquad_tf2": 8, "onepole": 5,
              "switching_scan": 1}
# K9 (kernels/dsp_scan.py): each wrapper's launch counter, and the
# launches of one VAR render (its biquads, one-poles and noise streams)
K9_COUNTERS = {"affine_scan": "AFFINE_LAUNCHES",
               "maxplus_scan": "MAXPLUS_LAUNCHES",
               "biquad_scan": "BIQUAD_LAUNCHES", "lcg_noise": "LCG_LAUNCHES"}
VAR_K9_LAUNCHES = {"affine_scan": 5, "maxplus_scan": 0, "biquad_scan": 8,
                   "lcg_noise": 2}
K9_EDGE_T = (1, 127, 128, 129, 4097)   # and two carry tiles of chunks
K9_LCG_SEEDS = (12345, 54321, 0, 2 ** 32 - 1)
# f64 operations a sample of each stage's recurrence (its bound's other
# side, far below the bytes): b = (1-a)*x and a*z + b; b = x and a*z + b;
# a*z and the max; y = b0*x + s1 and the state's seven
K9_OPS = {"onepole": 4, "integrator": 2, "max_follower": 2,
          "biquad_tf2": 9, "lcg_noise": 2}

# the spectral slice: STFT sizes, the bench's shapes (bench.py:137-206)
SPEC_SIZE, SPEC_HOP, PART = 2048, 512, 2048
# small odd shapes for K7a/K7b (lanes, T, size, hop): one and three lanes,
# a hop that does not divide the size, T < size, T not a multiple of hop
K7_ODD = [(1, 5000, 512, 128), (3, 7001, 600, 250), (1, 300, 512, 128),
          (3, 4097, 2048, 512), (1, 48000, 1024, 384)]
# (lanes, frames, bins, parts) for K8: one partition, an IR under one
# partition's worth of frames, parts beyond one staged group (64); then
# the edges of the walk of each tile (R frames a thread, W warps, 64
# partitions a group; the default R = 16, W = 8): frames 1, R - 1, R + 1,
# W*R + 1, two tiles and a bit; parts < R, 65, more than the frames,
# three groups; 33 bins; three lanes
K8_ODD = [(1, 5, 9, 1), (3, 7, 33, 4), (2, 3, 17, 9), (1, 20, 5, 70),
          (3, 130, 1025, 65), (1, 1, 2049, 64), (3, 1, 33, 5),
          (3, 15, 33, 9), (2, 17, 33, 65), (3, 129, 33, 130),
          (3, 259, 65, 131), (2, 31, 33, 7), (2, 33, 33, 40),
          (1, 65, 33, 66)]
# (lanes or None, T, IR taps, part_size) for the whole convolution
CONV_ODD = [(None, 20000, 100, 1024), (3, 5000, 3000, 512),
            (1, 700, 300, 256), (3, 4097, 9000, 256), (None, 100, 1000, 256)]
WSUM_MIN = 1e-3   # below it the OLA normalisation magnifies FFT rounding
# a complex MAC on the card: four multiplies and four adds, two roundings
# (no contraction), at the FP32 instruction rate (half the FMA peak)
F32_INSTR_PER_S = PEAK_OPS_PER_S["float32"] / 2
MAC_INSTR = 8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced(fn):
    """The profiler events of one fn() call, the card synchronised after
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device time of one fn() call: `reps` calls captured in one
    CUDA graph and replayed, so that the host's cost of each launch,
    which can exceed a short kernel's, does not separate the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                       # builds and first allocations, uncaptured
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, reps=replays) / reps
    del graph
    return ms


def scan_bound_ms(n_t: int, lanes: int, dtype: str):
    """Least time for the scan: bytes over HBM rate vs ops over peak."""
    itemsize = 8 if dtype == "float64" else 4
    nbytes = (2 * n_t * lanes + 3 * lanes) * itemsize
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = SCAN_OPS_PER_STEP * n_t * lanes / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def device_kernels(events):
    """The device events of a trace that are kernels or copies: not the
    device side of a `record_function` range."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("zorak.")]


def range_kernels(events, name):
    """(the CPU ranges `name` of a trace, the device kernels launched
    inside them): each kernel whose launch, the runtime's launch call,
    starts inside a range, matched by its correlation id.  The profiler
    gives a kernel bound through ctypes no op to hang on, so the ops
    inside a range would miss it; the launch calls see every kernel."""
    import bisect

    from torch.autograd import DeviceType

    ranges = sorted((e for e in events if e.name == name
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    starts = [r.time_range.start for r in ranges]
    ids = set()
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("cu") \
                and "Launch" in e.name:
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start <= ranges[i].time_range.end:
                ids.add(e.id)
    return ranges, [k for k in device_kernels(events) if k.id in ids]


def profile_render(render, label: str, segments: int = 0, traces: int = 3):
    """Device busy time, idle share and top kernels of one render, from
    the fullest of `traces` torch.profiler traces of the kernels it ran
    (a trace can miss a few of a render's launches); returns the device
    events a segment (None where the trace holds none or `segments` is 0)
    and (launches, device us) in the trace by kernel name."""
    kernels = max((device_kernels(traced(render)) for _ in range(traces)),
                  key=len)
    if not kernels:
        print("[profile] the trace holds no device events: busy time and "
              "idle share not measured")
        return None, {}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    per_seg = (f" ({len(kernels) / segments:.1f} a segment)" if segments
               else "")
    print(f"[profile] {label} render: {len(kernels)} device events{per_seg}, busy "
          f"{busy_us / 1e3:.2f} ms of a {span_us / 1e3:.2f} ms span, idle share "
          f"{1.0 - busy_us / span_us:.3f}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {us / 1e3:9.3f} ms  x{n:<4d} {name[:90]}")
    return len(kernels) / segments if segments else None, by_name


# K5's figures of each render that takes it (`k5_held`), printed as one
# `[k5]` JSON line before the `kernels` line
K5_ROWS = []


# K6's and K3b's wrappers (kernels/gated_index.py) by the counter each
# keeps; ring_cursor, the ungated cursor, launches K6a's kernel and counts
# with gated_cursor
GI_COUNTERS = {"gated_cursor": "CURSOR_LAUNCHES",
               "gated_draws": "DRAWS_LAUNCHES",
               "gated_ring_write": "WRITE_LAUNCHES",
               "dyn_ring_read": "READ_LAUNCHES"}
GI_WRAPPERS = (("gated_cursor", "gated_cursor"),
               ("gated_cursor", "ring_cursor"),
               ("gated_draws", "gated_draws"),
               ("gated_ring_write", "gated_ring_write"),
               ("dyn_ring_read", "dyn_ring_read"))


def gi_counts():
    from zorak_tpu_torch.kernels import gated_index as GI

    return {k: getattr(GI, attr) for k, attr in GI_COUNTERS.items()}


def gi_set_counts(counts):
    from zorak_tpu_torch.kernels import gated_index as GI

    for k, attr in GI_COUNTERS.items():
        setattr(GI, attr, counts[k])


def k5_counts():
    """The launch counters a K5 replay adds to, and K5's replays."""
    from zorak_tpu_torch.kernels import block_section as BS
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.kernels import segment_graph as K5

    return {"linrec_scan": LS.LAUNCHES, "ring_tap_sum": RT.LAUNCHES,
            "scan_group": SG.LAUNCHES, "block_section": BS.LAUNCHES,
            **gi_counts(), "replays": K5.LAUNCHES}


def k5_set_counts(counts):
    from zorak_tpu_torch.kernels import block_section as BS
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.kernels import segment_graph as K5

    (LS.LAUNCHES, RT.LAUNCHES, SG.LAUNCHES, BS.LAUNCHES,
     K5.LAUNCHES) = (counts[k] for k in ("linrec_scan", "ring_tap_sum",
                                         "scan_group", "block_section",
                                         "replays"))
    gi_set_counts(counts)


def k5_steps(kern, n: int) -> int:
    """The steps of a fresh render of n samples: blocks where @block is
    coupled, a hop kernel's spans (lead, hops, tail), else segments."""
    if kern._hop is not None:
        return len(kern._hop_spans(n, kern._hop_phase0))
    return -(-n // (kern.B if kern.coupled else kern.segment_length(n)))


def kernel_render(kern, x_dev):
    """render(step, n) of one kernel on x_dev [nch, T]: (y, the carry's
    tensors: svec, rings by region, K10's vars and heap)."""
    def render(step, n):
        y, carry = kern._render_device_as(step, x_dev[:, :n])
        if kern.has_device_view:
            (svec, rings), bvars, bmem = carry
            return y, [svec] + [rings[r] for r in sorted(rings)] + [bvars,
                                                                    bmem]
        svec, rings = carry
        return y, [svec] + [rings[r] for r in sorted(rings)]
    return render


def batch_render(br, x_dev):
    """render(step, n) of a BatchRenderer on x_dev [nf, nch, T]: (y, [])."""
    return lambda step, n: (br._render_as(step, x_dev[:, :, :n]), [])


# the device kernels of each wrapper whose launches a K5 replay adds, by a
# part of their names: K2's chunk, carry and chain kernels, K3's staged and
# global tap sums, K4's generated scan kernels, K10's section
K5_FAMILIES = (("linrec_scan", "linrec_"), ("ring_tap_sum", "ring_tap_sum"),
               ("scan_group", "zs_"), ("block_section", "zb_kernel"),
               ("gated_cursor", "gi_cursor_kernel"),
               ("gated_draws", "gi_draws_kernel"),
               ("gated_ring_write", "gi_write_kernel"),
               ("dyn_ring_read", "gi_read_kernel"))


def k5_trace(torch, render, n, steps):
    """One traced render of n samples (its keys captured before): host
    operations a step (the CUDA runtime's launches, graph launches,
    copies and sets inside the step's `zorak.k5` ranges, or, with no
    range, in the whole render), device events a step, busy ms a step
    and the copies' share of it (the device's memcpy and memset events:
    a render's carries and audio going in and out), the idle share, the
    device kernels of each K5_FAMILIES wrapper, and the LAUNCHES
    counters' and K5's replays' increments over the render."""
    from torch.autograd import DeviceType
    from zorak_tpu_torch.lowering import specialize as SP

    for attempt in range(1, 4):
        c0 = k5_counts()
        events = traced(lambda: render(n))
        c1 = k5_counts()
        if device_kernels(events):
            break
        # the profiler gave back no device event at all (the batch phase's
        # eager trace, in the whole script only): the render is traced
        # again, and the checks read the trace that holds events
        print(f"[k5] a trace of {n} samples held no device event "
              f"(attempt {attempt} of 3)")
    issued = [e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("cu")
              and any(w in e.name for w in ("Launch", "Memcpy", "Memset"))]
    ranges = [e.time_range for e in events if e.name == SP.K5_RANGE
              and e.device_type == DeviceType.CPU]
    if ranges:
        issued = [e for e in issued if any(
            r.start <= e.time_range.start <= r.end for r in ranges)]
    kernels = device_kernels(events)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    copies_us = sum(e.time_range.elapsed_us() for e in kernels
                    if e.name.startswith(("Memcpy", "Memset")))
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) if kernels else 0
    return {"host_ops": len(issued) / (len(ranges) or steps),
            "ranges": len(ranges), "device_events": len(kernels) / steps,
            "busy_ms": busy_us / 1e3 / steps,
            "copies_ms": copies_us / 1e3 / steps,
            "idle": 1.0 - busy_us / span_us if span_us else None,
            "families": {fam: sum(part in e.name for e in kernels)
                         for fam, part in K5_FAMILIES},
            "counted": {k: c1[k] - c0[k] for k in c0},
            "edges": [e.name[:60] for e in kernels[:2] + kernels[-2:]]}


def k5_traces(torch, label, render, nt, steps_t):
    """The replayed and the eager step's traces of nt samples (`k5_trace`;
    render(step, n) as `k5_held` takes it, every key captured before),
    held: every step of the replayed one replays, both count the same
    LAUNCHES, and the kernels on the card, counted by name in each, are
    what the launches put there: K3, K10, K6 and K3b one kernel a call,
    K2 and K4
    as many a call as the traces show.  A trace can lack events (late in
    the whole script, one K10 launch of 94, or a replayed trace's first 3
    steps, and again in a trace taken after it; never in the coupled phase
    alone): each is held to at most 5 % of a family's kernels lost.  A
    pair of traces where a family lost more (the batch phase's eager
    trace once held none of its K4 kernels, the launches counted as
    ever) is taken again, up to three times, and the checks read the
    last pair taken.
    Returns (the replayed trace, the eager one, the kernels by name the
    launches put there)."""
    for attempt in range(1, 4):
        tr_g = k5_trace(torch, lambda m: render(None, m), nt, steps_t)
        tr_e = k5_trace(torch, lambda m: render("eager", m), nt, steps_t)
        fam_g, fam_e = tr_g["families"], tr_e["families"]
        counted_g, counted_e = dict(tr_g["counted"]), dict(tr_e["counted"])
        replayed = counted_g.pop("replays")
        counted_e.pop("replays")
        check(replayed == steps_t, f"{label}: the traced render replayed "
              f"{replayed} of {steps_t} steps")
        check(counted_g == counted_e, f"{label}: LAUNCHES of the traced "
              f"second {counted_g} through K5, {counted_e} eager")
        per_call = {f: 1 if f in ("ring_tap_sum", "block_section")
                    or f in GI_COUNTERS else
                    round(max(fam_g[f], fam_e[f]) / counted_e[f])
                    if counted_e[f] else 0 for f in fam_e}
        expected = {f: counted_g[f] * per_call[f] for f in fam_e}
        lost = {f: (expected[f] - fam_g[f], expected[f] - fam_e[f])
                for f in expected}
        by_name = (all(0 <= n <= max(1, expected[f] // 20)
                       for f, pair in lost.items() for n in pair)
                   and all((expected[f] > 0) == (counted_g[f] > 0)
                           for f in expected))
        if by_name:
            break
        print(f"[k5] {label}: kernels on the card by name {fam_g} "
              f"replayed, {fam_e} eager, against {expected} from LAUNCHES "
              f"{counted_g} (attempt {attempt} of 3)")
    check(by_name,
          f"{label}: kernels on the card by name {fam_g} in the "
          f"replayed second, {fam_e} in the eager step's, against "
          f"{expected} from LAUNCHES {counted_g} (the traces' first "
          f"and last kernels {tr_g['edges']}, {tr_e['edges']})")
    return tr_g, tr_e, expected


def k5_held(torch, label, kern, render, T, card, turns_T=None, trace_T=None):
    """K5 on one render: `render(step, n)` renders the first n samples with
    the kernel's steps run as `step` says ("eager": the eager step, the
    yardstick; None: as a user's render runs them) and returns (y, the
    carry's tensors).  Holds the graph's render of T to the eager step's
    (audio and carry `same_values`, LAUNCHES equal), asserts the dispatch
    reads `graph` and that the third render replays every step (a key is
    captured the second time it is seen); prints wall times in turns
    (eager, graph, graph, eager on turns_T), the first render's captures
    and their seconds, host operations and device events a step and the
    idle share of a traced trace_T (a second), where every step must
    replay and the kernels on the card, counted by name in it and in the
    eager step's same second, must be what the launches put there
    (at most 5 % lost, what a trace can lack), and the captures' pool
    bytes.
    Returns the figures."""
    saved = k5_counts()
    k5_set_counts(dict.fromkeys(saved, 0))
    try:
        t0 = time.perf_counter()
        y_e, c_e = render("eager", T)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        eager_counts = k5_counts()
        check(kern.dispatch == "eager: the eager step, asked for",
              f"{label}: the yardstick ran as {kern.dispatch}")
        st0 = kern._k5.stats() if kern._k5 is not None else {
            "captures": 0, "capture_seconds": 0.0}
        k5_set_counts(dict.fromkeys(saved, 0))
        t0 = time.perf_counter()
        y_g, c_g = render(None, T)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        graph_counts = k5_counts()
        check(kern.dispatch == "graph", f"{label}: dispatch {kern.dispatch}")
        st1 = kern._k5.stats()
        captures = st1["captures"] - st0["captures"]
        capture_s = st1["capture_seconds"] - st0["capture_seconds"]
        replays = graph_counts.pop("replays")
        eager_counts.pop("replays")
        check(graph_counts == eager_counts, f"{label}: launches "
              f"{graph_counts} through K5, {eager_counts} eager")
        check(same_values(y_e, y_g) and len(c_e) == len(c_g) and all(
            same_values(a, b) for a, b in zip(c_e, c_g)),
            f"{label}: the graph's render differs from the eager step's")
        # a key is captured the second time it is seen: the second render
        # captures what the first saw once, and the third none
        for nth in ("second", "third"):
            st2 = kern._k5.stats()
            y_2, c_2 = render(None, T)
            check(same_values(y_e, y_2) and all(
                same_values(a, b) for a, b in zip(c_e, c_2)),
                f"{label}: the {nth} render through K5 differs from the "
                "eager step's")
        st3 = kern._k5.stats()
        check(st3["captures"] == st2["captures"]
              and st3["uncaptured"] == st2["uncaptured"]
              and st3["replays"] - st2["replays"] == k5_steps(kern, T),
              f"{label}: the third render replayed "
              f"{st3['replays'] - st2['replays']} of {k5_steps(kern, T)} "
              f"steps ({st3['captures'] - st2['captures']} captures, "
              f"{st3['uncaptured'] - st2['uncaptured']} uncaptured)")
        n = turns_T or T
        for _ in range(2):
            render(None, n)
        torch.cuda.synchronize()
        walls = {"eager": [], "graph": []}
        for step in ("eager", None, None, "eager"):
            t0 = time.perf_counter()
            render(step, n)
            torch.cuda.synchronize()
            walls[step or "graph"].append(time.perf_counter() - t0)
        nt = min(T, trace_T or int(SR))
        steps_t = k5_steps(kern, nt)
        for _ in range(2):
            render(None, nt)
        torch.cuda.synchronize()
        tr_g, tr_e, expected = k5_traces(torch, label, render, nt, steps_t)
        fam_g, fam_e = tr_g["families"], tr_e["families"]
        counted_g = {k: v for k, v in tr_g["counted"].items()
                     if k != "replays"}
        pool = kern._k5.pool_bytes()
        total = kern._k5.stats()
    finally:
        k5_set_counts(saved)
    steps = k5_steps(kern, T)
    row = {"label": label, "T": T, "steps": steps, "nf": int(y_g.shape[0])
           if y_g.dim() == 3 else 1, "eager_s": eager_s,
           "first_s": first_s, "captures": captures,
           "capture_s": capture_s, "replays": replays,
           "turns_T": n, "turns_eager_s": walls["eager"],
           "turns_graph_s": walls["graph"],
           "eager_ms_a_step": 1e3 * min(walls["eager"]) / k5_steps(kern, n),
           "graph_ms_a_step": 1e3 * min(walls["graph"]) / k5_steps(kern, n),
           "traced_T": nt, "graph_trace": tr_g, "eager_trace": tr_e,
           "pool_bytes": pool, "launches": graph_counts,
           "traced_kernels_by_name": fam_g,
           "eager_traced_kernels_by_name": fam_e,
           "kernels_from_launches": expected,
           "traced_launches": counted_g,
           "buffer_bytes": total["buffer_bytes"],
           "kernel_captures": total["captures"],
           "kernel_capture_s": total["capture_seconds"], "card": card}
    K5_ROWS.append(row)
    print(f"[k5] {label}: {T / SR:g} s in {steps} steps; dispatch graph, "
          f"audio and carry same_values the eager step's, launches "
          f"{graph_counts} equal the eager step's, {replays} replays; "
          f"first render {first_s:.4f} s with {captures} captures "
          f"({capture_s:.4f} s of it; the kernel's captures so far "
          f"{total['captures']} in {total['capture_seconds']:.4f} s), eager "
          f"{eager_s:.4f} s; wall in "
          f"turns on {n / SR:g} s: eager "
          f"{' '.join(f'{w:.4f}' for w in walls['eager'])}, graph "
          f"{' '.join(f'{w:.4f}' for w in walls['graph'])} s "
          f"({row['eager_ms_a_step']:.4f} against "
          f"{row['graph_ms_a_step']:.4f} ms a step); card='{card}'")
    print(f"[k5] {label}: a traced {nt / SR:g} s ({steps_t} steps): host "
          f"operations a step {tr_g['host_ops']:.2f} ({tr_g['ranges']} "
          f"step ranges) against {tr_e['host_ops']:.2f} eager; device "
          f"events a step {tr_g['device_events']:.1f} against "
          f"{tr_e['device_events']:.1f}; busy {tr_g['busy_ms']:.4f} against "
          f"{tr_e['busy_ms']:.4f} ms a step; idle share "
          + (f"{tr_g['idle']:.3f}" if tr_g["idle"] is not None else "not "
             "measured") + " against "
          + (f"{tr_e['idle']:.3f}" if tr_e["idle"] is not None else "not "
             "measured")
          + f"; the captures' pool "
          + (f"{pool} bytes" if pool is not None else "not measured")
          + f", static buffers {total['buffer_bytes']} bytes; kernels on "
          f"the card by name {fam_g} replayed, {fam_e} in the eager step's "
          f"trace, {expected} from LAUNCHES {counted_g} card='{card}'")
    check(tr_g["host_ops"] <= 4.0, f"{label}: {tr_g['host_ops']:.2f} host "
          "operations a step through K5")
    return row


def same_bits(a, b):
    """Equal as bit patterns (integer views), not as floats."""
    import torch

    iv = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(iv), b.view(iv))


def same_values(a, b):
    """Equal as bit patterns, every NaN counted as one value (no EEL2
    operation reads a NaN's sign or payload)."""
    import torch

    if a.shape != b.shape:
        return False
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros_like(a)
    return bool(torch.equal(nan_a, nan_b) and same_bits(
        torch.where(nan_a, zero, a), torch.where(nan_b, zero, b)))


K10_STAGED = ("gseg", "window", "ctl", "sub")   # a graph Stage's tensors


class K10Inputs(NamedTuple):
    """K10's inputs at one launch of a render, copied before it ran."""
    program: Any
    svec: Any
    rings: list
    bvars: Any
    bmem: Any
    sb: float
    stage: Any = None

    def copy(self, device=None):
        """The tensors copied (to `device` where given)."""
        def cp(t):
            if t is None:
                return None
            return t.clone() if device is None else t.to(device, copy=True)
        st = self.stage
        if st is not None:
            st = st._replace(**{k: cp(getattr(st, k)) for k in K10_STAGED})
        return self._replace(svec=cp(self.svec),
                             rings=[cp(r) for r in self.rings],
                             bvars=cp(self.bvars), bmem=cp(self.bmem),
                             stage=st)

    def run(self, fn, program=None):
        """fn (block_section, its earlier design or its plain version) on
        these tensors, in place, with `program` (else the recorded one);
        a comparison, so its launch is not counted: (ctrl, mout)."""
        from zorak_tpu_torch.kernels import block_section as BS

        saved = BS.LAUNCHES
        try:
            return fn(self.program if program is None else program,
                      self.svec, self.rings,
                      self.bvars, self.bmem, self.sb, stage=self.stage)
        finally:
            BS.LAUNCHES = saved


def k10_recording(wanted):
    """A stand-in for block_section that launches K10 and keeps the
    K10Inputs of the launches numbered in `wanted` (from 0): (got, spy,
    real), got filled as the render runs."""
    from zorak_tpu_torch.kernels import block_section as BS

    got, real, count = {}, BS.block_section, [0]

    def spy(program, svec, rings, bvars, bmem, samplesblock, midi=None,
            ctrl=None, mout=None, stage=None):
        if count[0] in wanted:
            got[count[0]] = K10Inputs(program, svec, rings, bvars, bmem,
                                      samplesblock, stage).copy()
        count[0] += 1
        return real(program, svec, rings, bvars, bmem, samplesblock, midi,
                    ctrl, mout, stage)
    return got, spy, real


def k10_plain_held(rec, what):
    """K10 on the card and its plain version on the CPU, each on a copy of
    one launch's inputs, held bit for bit (the sample side, vars, heap,
    control row, rings and a Stage's tensors): (max |delta|, the plain
    version's ms)."""
    import torch
    from zorak_tpu_torch.kernels import block_section as BS

    dev, cpu = rec.copy(), rec.copy("cpu")
    ctrl, _ = dev.run(BS.block_section)
    t0 = time.perf_counter()
    ctrl_p, _ = cpu.run(BS.block_section_plain)
    plain_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    pairs = [("svec", dev.svec, cpu.svec), ("vars", dev.bvars, cpu.bvars),
             ("heap", dev.bmem, cpu.bmem), ("control row", ctrl, ctrl_p)]
    pairs += [(f"ring {i}", a, b)
              for i, (a, b) in enumerate(zip(dev.rings, cpu.rings))]
    if rec.stage is not None:
        pairs += [(k, getattr(dev.stage, k), getattr(cpu.stage, k))
                  for k in K10_STAGED if getattr(rec.stage, k) is not None]
    err = 0.0
    for name, a, b in pairs:
        check(same_values(a.cpu(), b), f"{what}: {name} differs from the "
              "plain version")
        err = max(err, float((a.cpu() - b).abs().nan_to_num().max()))
    return err, plain_ms


def bound_ms(nbytes: float, ops: float, dtype: str = "float64"):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def linrec_phase(torch, cuda, rng):
    """K2 against `linrec_chunked`, the NumPy mirror of its order (equal,
    every NaN one value), and within TOL_REL x max|z| of the sequential
    loop and of its plain doubling ladder; times at the main shape."""
    from zorak_tpu_torch.kernels import linrec_scan as LS

    tol_rel = LS.TOL_REL
    worst = {"sequential": 0.0, "ladder": 0.0}

    def held(what, a, b, z0, exact_seq=False, overflow=False):
        at, bt, zt = (torch.from_numpy(v).to(cuda) for v in (a, b, z0))
        got = LS.linrec_scan(at, bt, zt)
        torch.cuda.synchronize()
        got = got.cpu()
        mirror = torch.from_numpy(LS.linrec_chunked(a, b, z0))
        check(same_values(got, mirror),
              f"linrec_scan {what} differs from linrec_chunked")
        seq = torch.from_numpy(LS.linrec_sequential(a, b, z0))
        if exact_seq:
            check(same_values(got, seq), f"linrec_scan {what} is not exact")
        ladder = LS.linrec_scan_reference(at, bt, zt).cpu()
        fin = torch.isfinite(seq)
        scale = float(seq[fin].abs().max()) if fin.any() else 1.0
        for name, ref in (("sequential", seq), ("ladder", ladder)):
            inf = torch.isinf(ref)
            # the ladder composes maps whose products overflow, so where
            # the loop overflows it may give NaN for inf: held on the
            # loop's finite values there
            check((overflow and name == "ladder")
                  or (torch.equal(torch.isnan(ref), torch.isnan(got))
                      and torch.equal(inf, torch.isinf(got))
                      and torch.equal(ref[inf], got[inf])),
                  f"linrec_scan {what}: NaN or inf elsewhere than the "
                  f"{name}'s")
            fin = torch.isfinite(seq) & torch.isfinite(ref)
            err = float((ref[fin] - got[fin]).abs().max()) if fin.any() else 0.0
            worst[name] = max(worst[name], err / max(scale, 1e-300))
            check(err <= tol_rel * scale, f"linrec_scan {what}: {name} "
                  f"differs by {err:.3e} (limit {tol_rel} x {scale:.3e})")

    for vec_a in (False, True):
        for k in (1, 2, 8):
            for n in (1, 7, 4096, SEG_L):
                a = rng.uniform(0.5, 0.99995, (k, n) if vec_a else (k,))
                a.flat[0] = 0.0                      # a = 0: z = b
                if k > 1:
                    a[1] = -a[1]
                b = rng.randn(k, n)
                z0 = rng.uniform(-1.0, 1.0, k)       # z0 != 0
                for with_nan in (False, True):
                    if with_nan:
                        if n < 7:
                            continue
                        b = b.copy()
                        b[-1, n // 2] = np.nan
                    held(f"k={k} L={n} vec_a={vec_a} nan={with_nan}", a, b, z0)
        # |a| > 1 (and one that overflows), an integrator on integer
        # counters (exact), L not a multiple of the chunk and below it
        for n in (100, 1000, SEG_L - 1):
            shape = (3, n) if vec_a else (3,)
            a = rng.uniform(1.0, 1.0 + 2.0 / n, shape)
            a[2] = 1.5                                 # overflows to inf
            held(f"|a| > 1 L={n} vec_a={vec_a}", a, rng.randn(3, n),
                 rng.uniform(-1.0, 1.0, 3), overflow=True)
            held(f"integrator L={n} vec_a={vec_a}", np.ones(shape),
                 rng.randint(-1000, 1000, (3, n)).astype(np.float64),
                 np.array([0.0, 5.0, -7.0]), exact_seq=True)
        print(f"[kernels] linrec_scan {'per-sample' if vec_a else 'scalar'}"
              f" a: k in (1, 2, 8), L in (1, 7, 4096, {SEG_L}), with and "
              "without NaN; |a| > 1 with overflow, integrators (exact), L "
              f"in (100, 1000, {SEG_L - 1}): equal to linrec_chunked "
              f"(chunk {LS.CHUNK}), within {tol_rel} x max|z| of the "
              f"sequential loop (worst {worst['sequential']:.3e}) and of the "
              f"plain ladder (worst {worst['ladder']:.3e})")

    # the main path's shape: the two one-poles of the delay network, one
    # wave of k = 2 rows with scalar a over a full segment
    k, n = 2, SEG_L
    a = torch.full((k,), 0.995, dtype=torch.float64, device=cuda)
    b = torch.from_numpy(rng.randn(k, n) * 0.05).to(cuda)
    z0 = torch.zeros(k, dtype=torch.float64, device=cuda)
    got = LS.linrec_scan(a, b, z0)
    ref = LS.linrec_scan_reference(a, b, z0)
    err = float((got - ref).abs().max())
    run = lambda: LS.linrec_scan(a, b, z0)
    run()
    scan_ms = cuda_ms(run, reps=50)
    one_chunk_ms = cuda_ms(lambda: LS.linrec_scan(a, b, z0, chunk=n), reps=10)
    plain_ms = cuda_ms(lambda: LS.linrec_scan_reference(a, b, z0), reps=5)
    av = torch.from_numpy(rng.uniform(0.5, 0.9999, (k, n))).to(cuda)
    vec_ms = cuda_ms(lambda: LS.linrec_scan(av, b, z0), reps=50)
    vec_plain_ms = cuda_ms(lambda: LS.linrec_scan_reference(av, b, z0), reps=5)
    scan_ms_2 = cuda_ms(run, reps=50)
    by_chunk = {c: cuda_ms(lambda c=c: LS.linrec_scan(a, b, z0, chunk=c),
                           reps=50) for c in (64, 128, 256, 512, 1024, 4096)}
    # each input read once, the output written once; 2 operations a step
    b_ms, b_by = bound_ms((2 * k * n + 2 * k) * 8, 2 * k * n)
    # the chain: the same dependent steps in one thread, a and b cycling
    # through registers (checked against the sequential loop first)
    ac = torch.from_numpy(rng.uniform(0.9, 0.9999, LS.CHAIN_CHUNK)).to(cuda)
    bc = torch.from_numpy(rng.randn(LS.CHAIN_CHUNK)).to(cuda)
    zc = torch.zeros(1, dtype=torch.float64, device=cuda)
    reps_c = 64
    z_seq = LS.linrec_sequential(
        np.tile(ac.cpu().numpy(), reps_c)[None],
        np.tile(bc.cpu().numpy(), reps_c)[None], np.zeros(1))[:, -1]
    check(same_bits(LS.linrec_chain_probe(ac, bc, zc, reps_c * LS.CHAIN_CHUNK).cpu(),
                    torch.from_numpy(z_seq)),
          "linrec chain probe differs from the sequential loop")
    chain_ms = cuda_ms(lambda: LS.linrec_chain_probe(ac, bc, zc, n), reps=5)
    chain_ns = chain_ms * 1e6 / n
    # the chunked scan's chains: compose and apply walk a chunk each, the
    # carry pass walks a row's maps
    n_chunks = -(-n // LS.CHUNK)
    chunk_chain_ms = (2 * LS.CHUNK + n_chunks - 1) * chain_ns * 1e-6
    print(f"[kernels] linrec_scan k={k} L={n} scalar a, chunk {LS.CHUNK}: "
          f"ms={scan_ms:.4f} (again {scan_ms_2:.4f}) one_chunk_ms="
          f"{one_chunk_ms:.4f} (a thread a row; the earlier one-thread walk "
          f"with helper warps read 1.344 ms on an NVIDIA H100 80GB HBM3 at "
          f"700 W) plain_ms={plain_ms:.4f} "
          f"max_abs_err_vs_ladder={err:.3e} bound_ms={b_ms:.5f} ({b_by}) "
          f"chain_ms={chain_ms:.4f} ({chain_ns:.3f} ns a step), the kernel "
          f"{scan_ms / chain_ms:.3f}x it; chunked chains (2 x {LS.CHUNK} + "
          f"{n_chunks - 1} steps) {chunk_chain_ms:.4f} ms, the kernel "
          f"{scan_ms / chunk_chain_ms:.3f}x it; per-sample a: ms={vec_ms:.4f} "
          f"plain_ms={vec_plain_ms:.4f}")
    print("[kernels] linrec_scan k=2 L=%d scalar a, ms by chunk: %s" % (
        n, " ".join(f"{c}: {v:.4f}" for c, v in by_chunk.items())))
    return {
        "name": "linrec_scan", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/linrec_scan.cu",
        "replaces": "zorak_tpu/lowering/eelmath.py:277",
        "launches": 0, "max_abs_err": err, "ms": scan_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "chain_ms": chain_ms,
        "chunk_chain_ms": chunk_chain_ms, "earlier_ms": one_chunk_ms,
        "chunk": LS.CHUNK, "ms_by_chunk": by_chunk, "vector_a_ms": vec_ms,
        "vector_a_plain_ms": vec_plain_ms,
        "worst_rel_err_vs_sequential": worst["sequential"],
        "worst_rel_err_vs_ladder": worst["ladder"], "shape": [k, n],
    }


def tap_case(rng, n_taps, mod, n, long_only=False):
    """A ring [mod] and a stream [n] (None: every delay >= n, history
    alone) with tap starts spread over [history | stream], delay 0 (start
    mod) and delay mod (start 0) included."""
    hi = mod - n if long_only else mod
    starts = rng.randint(0, hi + 1, n_taps)
    starts[0], starts[-1] = hi, 0
    return (rng.randn(mod), None if long_only else rng.randn(n),
            starts.tolist(), rng.uniform(-0.1, 0.1, n_taps).tolist())


def tap_bounds(tables, streamed, n, sms, clock_hz):
    """K3's three floors for one launch: the f64 instructions at two
    roundings (a DMUL and a DADD a tap and sample, each at the DFMA
    instruction rate), one 8-byte on-chip read a tap and sample, and the
    bytes from device memory (the part of each buffer the taps reach,
    output, tables; the inits are scalars)."""
    taps = sum(tables.counts)
    ops_ms = 2 * taps * n / F64_INSTR_PER_S * 1e3
    smem_ms = 8 * taps * n / (SMEM_BYTES_PER_CLK * sms * clock_hz) * 1e3
    nbytes = 12 * taps
    for st, (mod, has_stream) in zip(tables.starts, streamed):
        end = min(max(st) + n, mod + (n if has_stream else 0))
        nbytes += 8 * (end - min(st) + n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    floors = {"operations": ops_ms, "on-chip reads": smem_ms,
              "bytes": bytes_ms}
    return floors, max(floors, key=floors.get)


def ring_taps_phase(torch, cuda, rng):
    """K3 against its plain fold, bit-identical (single chains, batches,
    wrapped cursors, history alone, windows cut to fit, both designs);
    then, at the two delay networks' planned launches, each part of the
    design timed on its own beside the earlier design, the plain fold, a
    dense-FIR convolution (the library call) and the three floors."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import ring_taps as RT
    from zorak_tpu_torch.runtime.engine import PluginInstance

    def T(v):
        return torch.from_numpy(np.asarray(v, dtype=np.float64)).to(cuda)

    def on_card(chains, cursors, n, tile=None):
        """chains: (ring, stream, starts, gains, init) in numpy and lists
        -> the wrapper's arguments on the card (tile None: the planner's
        choice for L = n)."""
        tables = RT.TapTables([(st, g) for _r, _s, st, g, _i in chains],
                              cuda, tile, n)
        return (tables, [T(r) for r, *_ in chains], list(cursors),
                [None if s is None else T(s) for _r, s, *_ in chains],
                [T(i) if isinstance(i, np.ndarray) else i
                 for *_, i in chains], n)

    def held(what, args, staged=True):
        got = RT.ring_tap_sum(*args, staged=staged)
        ref = RT.ring_tap_sum_reference(*args)
        torch.cuda.synchronize()
        check(same_bits(got, ref), f"ring_tap_sum {what} "
              f"({'staged' if staged else 'global'}) differs from its plain "
              "fold")

    for n_taps, mod in ((16, 4096), (192, 16384), (300, 16384)):
        for n in (SEG_L, 6784, 1):
            for long_only in (False, True):
                if long_only and n > mod:
                    continue
                ring, stream, starts, gains = tap_case(rng, n_taps, mod, n,
                                                       long_only)
                for start in (0, mod - 1, mod // 2 + 3):
                    for init in (0.0, rng.randn(n)):
                        args = on_card([(ring, stream, starts, gains, init)],
                                       [start], n)
                        what = (f"taps={n_taps} mod={mod} L={n} long_only="
                                f"{long_only} start={start}")
                        held(what, args)
                        held(what, args, staged=False)
        print(f"[kernels] ring_tap_sum taps={n_taps} mod={mod}, L in ({SEG_L}, "
              "6784, 1), delays 0 to mod, history alone, cursor starts 0, "
              "mod - 1 and the middle, scalar and stream init, staged and "
              "global kernels: bit-identical to the plain fold")
    # a batch: tables of 2 to 300 taps, rings of three sizes, history
    # alone beside streams, scalar, stream and 0-d inits; a chain whose
    # taps span 2^18 samples, cut into windows; every tile
    for n in (SEG_L, 6784, 1):
        parts = [tap_case(rng, 2, 64, n), tap_case(rng, 16, 4096, n),
                 tap_case(rng, 300, 16384, n),
                 tap_case(rng, 24, 1 << 18, n, long_only=n < 1 << 18),
                 tap_case(rng, 192, 16384, n, long_only=n <= 16384)]
        inits = [0.0, rng.randn(n), np.array(-0.5), 1.25, rng.randn(n)]
        chains = [p + (i,) for p, i in zip(parts, inits)]
        cursors = [int(rng.randint(0, len(c[0]))) for c in chains]
        for tile in RT.TILES:
            args = on_card(chains, cursors, n, tile)
            held(f"batch of {len(chains)} L={n} tile={tile} windows="
                 f"{args[0].n_windows}", args)
        held(f"batch of {len(chains)} L={n}", args, staged=False)
    print(f"[kernels] ring_tap_sum batches of 5 chains (2 to 300 taps, rings "
          f"of 64 to 2^18, history alone, 0-d inits, windows cut to fit), "
          f"tiles {RT.TILES}: bit-identical to the plain fold")

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    out = {}
    for label, src in (("fallback", BP.FALLBACK_SRC),
                       ("wide", BP.wide_delay_network(192))):
        n = SEG_L
        kern = PluginInstance(compile_plugin_source(src), srate=SR).kernel
        launches = kern.tap_launches(n)
        check(len(launches) == 1 and len(launches[0].members) == 2,
              f"{label}: {len(launches)} tap launches planned")
        chains = []
        for m in launches[0].members:
            mod = m.region[1]
            chains.append((rng.randn(mod), rng.randn(n) if m.needs_src
                           else None, m.starts, m.gains, 0.0))
        cursors = [int(rng.randint(0, len(c[0]))) for c in chains]
        pair = on_card(chains, cursors, n)
        one = on_card(chains[:1], cursors[:1], n)
        other = on_card(chains[1:], cursors[1:], n)
        got = RT.ring_tap_sum(*pair)
        ref = RT.ring_tap_sum_reference(*pair)
        torch.cuda.synchronize()
        check(same_bits(got, ref), f"ring_tap_sum {label} pair differs from "
              "its plain fold")
        err = float((got - ref).abs().max())
        streamed = [(len(c[0]), c[1] is not None) for c in chains]

        def joined(ring, start, stream):
            # the buffer the emitter built for a chain before reading in
            # place: the history joined at the wrap, then [history | stream]
            hist = torch.cat([ring[start:], ring[:start]])
            return hist if stream is None else torch.cat([hist, stream])

        timed = {
            "ms": lambda: RT.ring_tap_sum(*pair),
            "one_chain_ms": lambda: RT.ring_tap_sum(*one),
            "earlier_one_chain_ms": lambda: RT.ring_tap_sum(*one,
                                                            staged=False),
            "two_launches_ms": lambda: (RT.ring_tap_sum(*one),
                                        RT.ring_tap_sum(*other)),
            "earlier_ms": lambda: (RT.ring_tap_sum(*one, staged=False),
                                   RT.ring_tap_sum(*other, staged=False)),
            "cat_ms": lambda: [joined(*a) for a in zip(pair[1], cursors,
                                                       pair[3])],
        }
        # the kernels' device time, in turns, twice: forwards, then
        # backwards; and the pair's launches back to back by CUDA events,
        # where the host's launch cost shows
        times = {k: [] for k in timed}
        for order in (list(timed), list(timed)[::-1]):
            for k in order:
                times[k].append(graph_ms(timed[k]))
        res = {k: min(v) for k, v in times.items()}
        spread = max(max(v) / min(v) for v in times.values())
        res["events_ms"] = cuda_ms(timed["ms"], reps=20)
        res["plain_ms"] = graph_ms(
            lambda: RT.ring_tap_sum_reference(*pair), reps=3)
        # one PyTorch call for the same function: the taps of each chain
        # as a dense FIR, both chains as the groups of one convolution
        firs, sigs = [], []
        for c, (ring, start, stream) in enumerate(zip(pair[1], cursors,
                                                      pair[3])):
            starts, gains = chains[c][2], chains[c][3]
            s_min, s_max = min(starts), max(starts)
            fir = torch.zeros(s_max - s_min + 1, dtype=torch.float64,
                              device=cuda)
            fir.index_add_(0, torch.tensor(starts, device=cuda) - s_min,
                           T(gains))
            firs.append(fir)
            sigs.append(joined(ring, start, stream)[s_min:s_max + n])
        check(len({f.numel() for f in firs}) == 1,
              f"{label}: the chains' FIRs differ in length")
        weight, sig = torch.stack(firs)[:, None], torch.stack(sigs)[None]
        lib = torch.nn.functional.conv1d(sig, weight, groups=len(firs))[0]
        lib_err = float((lib - ref).abs().max())
        check(lib.shape == ref.shape and lib_err < 1e-9,
              f"dense-FIR convolution disagrees with the tap sum: {lib_err:.3e}")
        res["library_ms"] = graph_ms(lambda: torch.nn.functional.conv1d(
            sig, weight, groups=len(firs)), reps=3)
        tiles, tiles_one = {}, {}
        for tile in RT.TILES:
            args = on_card(chains, cursors, n, tile)
            held(f"{label} pair tile={tile}", args)
            tiles[tile] = graph_ms(lambda: RT.ring_tap_sum(*args))
            args = on_card(chains[:1], cursors[:1], n, tile)
            tiles_one[tile] = graph_ms(lambda: RT.ring_tap_sum(*args))
        floors1, by1 = tap_bounds(one[0], streamed[:1], n, sms, max_mhz * 1e6)
        floors2, by2 = tap_bounds(pair[0], streamed, n, sms, max_mhz * 1e6)
        print(f"[kernels] ring_tap_sum {label}: taps={one[0].counts[0]} a "
              f"chain, rings {[c[0] for c in streamed]}, L={n}, windows "
              f"{pair[0].n_windows} for 2 chains, tile {pair[0].tile} for "
              f"the pair and {one[0].tile} for one chain, shared memory "
              f"{pair[0].smem_bytes} B a block; bit-identical max_abs_err="
              f"{err:.3e}")
        print(f"[kernels] ring_tap_sum {label}: one chain {res['one_chain_ms']:.4f}"
              f" ms, earlier design (a thread a sample, global reads) "
              f"{res['earlier_one_chain_ms']:.4f}; the pair in one launch "
              f"ms={res['ms']:.4f}, in two launches "
              f"{res['two_launches_ms']:.4f}, earlier design in two launches "
              f"{res['earlier_ms']:.4f}; the buffers the emitter joined before "
              f"reading in place (4 cats) {res['cat_ms']:.4f} ms; plain fold "
              f"{res['plain_ms']:.4f}; conv1d (two dense FIRs of "
              f"{firs[0].numel()} taps, max |delta| {lib_err:.3e}) "
              f"{res['library_ms']:.4f}; spread over two turns (max/min) "
              f"{spread:.3f} (device time: 20 calls in a CUDA graph); the pair's "
              f"launches back to back by CUDA events {res['events_ms']:.4f}")
        print(f"[kernels] ring_tap_sum {label}: by tile, the pair "
              + ", ".join(f"{t}: {ms:.4f}" for t, ms in tiles.items())
              + " ms; one chain "
              + ", ".join(f"{t}: {ms:.4f}" for t, ms in tiles_one.items())
              + " ms")
        for what, floors, by in (("one chain", floors1, by1),
                                 ("the pair", floors2, by2)):
            print(f"[kernels] ring_tap_sum {label} {what} floors: operations "
                  f"at two roundings {floors['operations']:.5f} ms, on-chip "
                  f"reads {floors['on-chip reads']:.5f} ms ({SMEM_BYTES_PER_CLK}"
                  f" B/clk x {sms} SMs at {max_mhz:.0f} MHz, the max SM "
                  f"clock), bytes {floors['bytes']:.5f} ms; binds: {by}")
        res.update({
            "max_abs_err": err, "tiles_ms": tiles,
            "one_chain_tiles_ms": tiles_one, "spread": spread,
            # the contract's bound, for the pair: bytes or operations
            "bound_ms": max(floors2["bytes"], floors2["operations"]),
            "bound_by": ("bytes" if floors2["bytes"] >= floors2["operations"]
                         else "operations"),
            "floors_ms": floors2, "binds": by2,
            "one_chain_floors_ms": floors1, "one_chain_binds": by1,
            "tile": pair[0].tile,
            "shape": [len(chains), one[0].counts[0], streamed[0][0], n]})
        out[label] = res
    fb = out["fallback"]
    return {
        "name": "ring_tap_sum", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/ring_taps.cu",
        "replaces": "zorak_tpu/lowering/specialize.py:4392",
        "launches": 0, "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": fb["bound_by"], "library_ms": fb["library_ms"],
        "shape": fb["shape"], "fallback": fb, "wide": out["wide"],
    }


def scan_group_phase(torch, cuda, rng):
    """K4, generated from each body's own step list, against the plain
    Python loop on the same CUDA inputs; times at L = 131,072 beside the
    plain loop, a one-thread chain probe, the bytes bound and a
    launch-per-sample estimate (printed, not part of the `kernels` line:
    it is computed from one measured launch).  Returns K4's entry of the
    `kernels` line (the follower body's numbers; every body's under
    `bodies`)."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build, scan_group as SG
    from zorak_tpu_torch.lowering.scan_codegen import TRANSCENDENTAL
    from zorak_tpu_torch.lowering.specialize import _SC_BINARY, _SC_UNARY
    from zorak_tpu_torch.runtime.engine import PluginInstance

    programs = {}
    for name, (src, _nch) in K4_BODIES.items():
        inst = PluginInstance(compile_plugin_source(src), srate=SR)
        check(inst.engine == "torch-vector" and inst.spec_error is None,
              f"{name}: engine {inst.engine} ({inst.spec_error})")
        levels = inst.kernel.scan_level_programs()
        check(len(levels) == 1, f"{name}: {len(levels)} scan levels")
        programs[name] = levels[min(levels)][2]
    # the render's source holds the scan kernel alone; the chain probe is
    # the same steps in a source of its own
    probes = {name: SG.ScanGroupProgram(p.steps, p.outs, p.n_ext, probe=True)
              for name, p in programs.items()}
    # every operation of csrc/scan_ops.cuh as a carry of its own: binary
    # ops on (x0, x1), unary ops on x0, a select
    op_names = ([f"bin {op}" for op in sorted(_SC_BINARY)]
                + [f"call {op}" for op in sorted(_SC_UNARY)] + ["select"])
    op_steps = ([("bin", op, {}, [("x", 0), ("x", 1)])
                 for op in sorted(_SC_BINARY)]
                + [("call", op, {}, [("x", 0)]) for op in sorted(_SC_UNARY)]
                + [("select", None, {}, [("x", 0), ("x", 1), ("c", -3.25)])])
    ops_program = SG.ScanGroupProgram(
        op_steps, [("s", i) for i in range(len(op_steps))], 2)
    # one nvcc a generated source, all started together
    t0 = time.perf_counter()
    logs = _build.build_generated(
        [p.source for p in programs.values()]
        + [p.source for p in probes.values()] + [ops_program.source])
    print(f"[build] {len(logs)} generated scan-group kernels in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, program in programs.items():
        for line in logs[program.source].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] scan_group {name}: {line.strip()}")

    # what one eager launch costs the host: a launch-per-sample loop in
    # plain PyTorch would pay it for every operation of every sample
    acc = torch.zeros((), dtype=torch.float64, device=cuda)
    for _ in range(200):
        acc.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        acc.add_(1.0)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / 2000 * 1e6

    def inputs(program, n, specials):
        xs = rng.randn(n, program.n_ext) * 0.5
        if specials:
            xs[n // 3, 0] = -0.0
            xs[2, 0] = 0.0
            xs[3 * n // 4, -1] = np.nan    # reaches the carry and stays
        c0 = rng.uniform(0.1, 0.9, program.n_carry)     # non-zero start
        return (torch.from_numpy(xs).to(cuda), torch.from_numpy(c0).to(cuda))

    def program_like(xs):
        """Noise with a silent lead-in, a silent gap and a fade-out."""
        xs = xs.clone()
        n = xs.shape[0]
        xs[:2000] = 0.0
        xs[n // 4:n // 4 + 10_000] = 0.0
        xs[-20_000:] *= torch.linspace(1.0, 0.0, 20_000, dtype=xs.dtype,
                                       device=xs.device)[:, None]
        return xs

    def held(program, what, got, ref):
        if program.transcendental:
            fin = torch.isfinite(ref)
            check(torch.equal(torch.isnan(got), torch.isnan(ref)),
                  f"{what}: NaNs elsewhere than the plain loop's")
            err = float((got[fin] - ref[fin]).abs().max()) \
                if fin.any() else 0.0
            check(err <= K4_LIBM_TOL, f"{what}: differs from the "
                  f"plain loop by {err:.3e} (limit {K4_LIBM_TOL})")
        else:
            check(same_values(got, ref), f"{what} differs from its plain loop")
            fin = torch.isfinite(ref)
            err = float((got[fin] - ref[fin]).abs().max()) \
                if fin.any() else 0.0
        return err

    def reruns_of(fn):
        for v in SG.RERUN_STEPS.values():
            v.zero_()
        out = fn()
        torch.cuda.synchronize()
        return out, sum(int(v.item()) for v in SG.RERUN_STEPS.values())

    def merge_step(program, xs, c0):
        """Samples after which a walk started from c0 at a quarter, a
        half and three quarters of xs has the true walk's carries in
        every bit, and keeps them (the most of the three); None if one
        never does within xs."""
        n = xs.shape[0]
        one = {"chunk": n}
        true = SG.scan_group(program, xs, c0, **one).view(torch.int64)
        worst = 0
        for t_s in (n // 4, n // 2, 3 * n // 4):
            guess = SG.scan_group(program, xs[t_s:].contiguous(), c0, **one)
            differs = (guess.view(torch.int64) != true[t_s:]).any(dim=1)
            last = torch.nonzero(differs)
            if len(last) and int(last[-1]) == n - t_s - 1:
                return None
            worst = max(worst, int(last[-1]) + 1 if len(last) else 0)
        return worst

    small = {"chunk": 64, "warmup": 256}   # many chunks, many re-runs
    bodies = {}
    for name, program in programs.items():
        worst = 0.0
        plain_ms = None
        for n in (1, 7, 4096, SEG_L):
            for specials in (False, True):
                if specials and (n < 7 or not program.n_ext):
                    continue
                xs, c0 = inputs(program, n, specials)
                got = SG.scan_group(program, xs, c0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
                if n == SEG_L and not specials:
                    plain_ms = (time.perf_counter() - t0) * 1e3
                what = f"scan_group {name} L={n} specials={specials}"
                worst = max(worst, held(program, what, got, ref))
                # a small chunk and warm-up: many chunks re-run; twice, so
                # that a launch after a fallback to the walk in series is
                # held too
                for _ in range(2):
                    held(program, f"{what} {small}",
                         SG.scan_group(program, xs, c0, **small), ref)
        # time at the main path's segment length beside the walk in series
        # (one chunk: the earlier design's walk) and the chain probe: the
        # same steps with the externals cycling through registers, checked
        # against the plain loop on the same repeated rows first
        xs, c0 = inputs(program, SEG_L, False)
        run = lambda: SG.scan_group(program, xs, c0)
        _, reruns = reruns_of(run)
        ms = cuda_ms(run, reps=20)
        walk_ms = cuda_ms(lambda: SG.scan_group(program, xs, c0, chunk=SEG_L),
                          reps=10)
        xp = program_like(xs)
        _, prog_reruns = reruns_of(lambda: SG.scan_group(program, xp, c0))
        prog_ms = cuda_ms(lambda: SG.scan_group(program, xp, c0), reps=20)
        merge = (merge_step(program, xs, c0), merge_step(program, xp, c0))
        probe = probes[name]
        rows = probe.block_rows
        xc = xs[:rows].contiguous()
        n_check = 64 * rows
        ref_end = SG.scan_group_plain(program.steps, program.outs,
                                      xc.repeat(64, 1), c0)[-1]
        got_end = SG.scan_group_chain_probe(probe, xc, c0, n_check)
        if program.transcendental:
            check(float((got_end - ref_end).abs().max()) <= K4_LIBM_TOL,
                  f"scan_group {name}: chain probe differs from the plain loop")
        else:
            check(same_values(got_end, ref_end),
                  f"scan_group {name}: chain probe differs from the plain loop")
        chain_ms = cuda_ms(
            lambda: SG.scan_group_chain_probe(probe, xc, c0, SEG_L), reps=5)
        chain_ns = chain_ms * 1e6 / SEG_L
        chunk, warm, n_chunks = SG.chunk_plan(SEG_L, SG.CHUNK, SG.WARMUP)
        chunk_chain_ms = (warm + chunk) * chain_ns * 1e-6
        ms_2 = cuda_ms(run, reps=20)
        n_ops = len(program.steps)
        # each external read once, each carry stream written once; the
        # operations bound counts every step of the body as one operation
        b_ms, b_by = bound_ms((program.n_ext + program.n_carry) * SEG_L * 8
                              + program.n_carry * 8, n_ops * SEG_L)
        per_sample_ms = n_ops * SEG_L * launch_us * 1e-3
        how = (f"within {K4_LIBM_TOL} (device libm)" if program.transcendental
               else "bit-identical")
        print(f"[kernels] scan_group {name}: {program.n_carry} carries in "
              f"{len(program.components)} component(s), {program.n_ext} "
              f"externals, {n_ops} steps; L in (1, 7, 4096, {SEG_L}), with "
              f"and without NaN and -0.0, chunk {chunk} warm-up {warm} and "
              f"{small}: {how}, max_abs_err={worst:.3e}; L={SEG_L}: "
              f"ms={ms:.4f} (again {ms_2:.4f}) rerun_steps={reruns} "
              f"walk_in_series_ms={walk_ms:.4f} plain_ms={plain_ms:.1f} "
              f"chain_ms={chain_ms:.4f} ({chain_ns:.3f} ns a step), the "
              f"kernel {ms / chain_ms:.3f}x it; chunked chain bound ({warm} + "
              f"{chunk} steps) {chunk_chain_ms:.4f} ms, the kernel "
              f"{ms / chunk_chain_ms:.3f}x it; program-like material: "
              f"ms={prog_ms:.4f} rerun_steps={prog_reruns}; merge step on "
              f"noise {merge[0]}, on program-like material {merge[1]} "
              f"(None: not within the segment); bound_ms={b_ms:.5f} "
              f"({b_by}); a launch a step and sample at {launch_us:.2f} us "
              f"would take {per_sample_ms:.0f} ms")
        bodies[name] = {
            "ms": ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
            "chunk_chain_ms": chunk_chain_ms, "earlier_ms": walk_ms,
            "rerun_steps": reruns, "program_ms": prog_ms,
            "program_rerun_steps": prog_reruns, "merge_step": merge[0],
            "program_merge_step": merge[1],
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": worst,
            "steps": n_ops,
            "carries": program.n_carry, "externals": program.n_ext,
            "components": len(program.components)}

    # the follower after a burst into exact silence: two walks from other
    # carries keep a fixed ratio and never meet, so every launch that
    # speculates re-walks most of the segment and the next walks in series
    fol = programs["follower"]
    xs, c0 = inputs(fol, SEG_L, False)
    xs[SEG_L // 64:] = 0.0
    ref = SG.scan_group_plain(fol.steps, fol.outs, xs, c0)
    silence_reruns = []
    for _ in range(4):
        got, r = reruns_of(lambda: SG.scan_group(fol, xs, c0))
        held(fol, "scan_group follower, burst into silence", got, ref)
        silence_reruns.append(r)
    check(sorted(r == 0 for r in silence_reruns) == [False, False, True, True],
          f"follower in silence: re-run steps {silence_reruns}, expected "
          "a launch that re-walks and one in series, in turns")
    silence_ms = cuda_ms(lambda: SG.scan_group(fol, xs, c0), reps=22)
    silence_walk_ms = cuda_ms(
        lambda: SG.scan_group(fol, xs, c0, chunk=SEG_L), reps=22)
    print(f"[kernels] scan_group follower, burst into exact silence, "
          f"L={SEG_L}: bit-identical; re-run steps of four launches in a "
          f"row {silence_reruns}; ms={silence_ms:.4f} (mean of 22, half of "
          f"them in series) walk_in_series_ms={silence_walk_ms:.4f}, "
          f"{silence_ms / silence_walk_ms:.3f}x it")

    # the operations one by one, every pair of K4_EDGE_VALUES: what the
    # scalar semantics give (the plain loop), bit for bit; the device's
    # libm calls within K4_LIBM_ULPS of glibc's, same NaNs and infinities
    xs = torch.tensor([(a, b) for a in K4_EDGE_VALUES for b in K4_EDGE_VALUES],
                      dtype=torch.float64, device=cuda)
    c0 = torch.zeros(ops_program.n_carry, dtype=torch.float64, device=cuda)
    got = SG.scan_group(ops_program, xs, c0)
    ref = SG.scan_group_plain(ops_program.steps, ops_program.outs, xs, c0)
    worst_ulps = 0.0
    for i, name in enumerate(op_names):
        g, r = got[:, i], ref[:, i]
        if name.split()[-1] in TRANSCENDENTAL:
            fin = torch.isfinite(r)
            check(torch.equal(torch.isnan(g), torch.isnan(r))
                  and torch.equal(g[torch.isinf(r)], r[torch.isinf(r)]),
                  f"scan_group op {name}: NaNs or infinities elsewhere than "
                  "the plain loop's")
            ulp = (torch.nextafter(r[fin].abs(), torch.full_like(r[fin], np.inf))
                   - r[fin].abs())
            ulps = float(((g[fin] - r[fin]).abs() / ulp).max()) \
                if fin.any() else 0.0
            check(ulps <= K4_LIBM_ULPS, f"scan_group op {name}: {ulps:.1f} "
                  f"ulp from the plain loop (limit {K4_LIBM_ULPS})")
            worst_ulps = max(worst_ulps, ulps)
        else:
            bad = [tuple(xs[j].tolist()) + (float(g[j]), float(r[j]))
                   for j in range(xs.shape[0])
                   if not same_values(g[j:j + 1], r[j:j + 1])][:3]
            check(not bad, f"scan_group op {name} differs from the scalar "
                  f"semantics at (a, b, kernel, plain) {bad}")
    print(f"[kernels] scan_group operations: {len(op_names)} ops on "
          f"{xs.shape[0]} pairs of edge values (zeros, subnormals, +-2^31, "
          f"+-2^62, +-2^63, +-inf, NaN): bit-identical to the scalar "
          f"semantics; the {sum(n.split()[-1] in TRANSCENDENTAL for n in op_names)}"
          f" libm ops within {worst_ulps:.2f} ulp (limit {K4_LIBM_ULPS})")

    fol = bodies["follower"]
    return {
        "name": "scan_group", "route": "cuda",
        "source": "zorak_tpu_torch/lowering/scan_codegen.py",
        "replaces": "zorak_tpu/lowering/specialize.py:4482",
        "launches": 0, "max_abs_err": fol["max_abs_err"], "ms": fol["ms"],
        "plain_ms": fol["plain_ms"], "bound_ms": fol["bound_ms"],
        "bound_by": fol["bound_by"], "library_ms": None,
        "chain_ms": fol["chain_ms"], "chunk_chain_ms": fol["chunk_chain_ms"],
        "earlier_ms": fol["earlier_ms"], "rerun_steps": fol["rerun_steps"],
        "chunk": SG.CHUNK, "warmup": SG.WARMUP,
        "silence_ms": silence_ms, "silence_walk_ms": silence_walk_ms,
        "silence_rerun_steps": silence_reruns, "eager_launch_us": launch_us,
        "worst_abs_err": max(b["max_abs_err"] for b in bodies.values()),
        "shape": [SEG_L, fol["externals"], fol["carries"]], "bodies": bodies,
    }


def scan_group_sweep(torch, cuda, rng, rounds=5, reps=10):
    """K4 across register block sizes: for each of K4_SWEEP_UNROLLS the
    bodies of K4_SWEEP_BODIES generated with that many samples held at
    once, held to the default size's output bit for bit at L = 131,072,
    then timed in a rotating order (mean, min, max of `rounds` samples of
    `reps` launches) beside the body's chain probe."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build, scan_group as SG
    from zorak_tpu_torch.lowering import scan_codegen as CG
    from zorak_tpu_torch.runtime.engine import PluginInstance

    bases, programs = {}, {}
    for name in K4_SWEEP_BODIES:
        inst = PluginInstance(compile_plugin_source(K4_BODIES[name][0]),
                              srate=SR)
        ((_keys, _ext, base, _idx),) = inst.kernel.scan_level_programs().values()
        bases[name] = SG.ScanGroupProgram(base.steps, base.outs, base.n_ext,
                                          probe=True)
        for u in K4_SWEEP_UNROLLS:
            programs[name, u] = SG.ScanGroupProgram(
                base.steps, base.outs, base.n_ext, unroll=u)
        # the speculate kernel's other way to load the externals
        programs[name, "other"] = SG.ScanGroupProgram(
            base.steps, base.outs, base.n_ext,
            staged=base.n_ext > CG.STAGE_MAX_EXT)
    _build.build_generated([p.source for p in (*bases.values(),
                                               *programs.values())])
    for name, base in bases.items():
        xs = torch.from_numpy(rng.randn(SEG_L, base.n_ext) * 0.5).to(cuda)
        c0 = torch.from_numpy(rng.uniform(0.1, 0.9, base.n_carry)).to(cuda)
        runs = {u: (lambda p=programs[name, u]: SG.scan_group(p, xs, c0))
                for u in K4_SWEEP_UNROLLS}
        ref = SG.scan_group(base, xs, c0)
        for u, run in runs.items():
            check(same_values(run(), ref),
                  f"scan_group {name} with {u} samples held differs from "
                  "the default")
        xc = xs[:base.block_rows].contiguous()
        chain_ms = cuda_ms(
            lambda: SG.scan_group_chain_probe(base, xc, c0, SEG_L), reps=5)
        samples = {u: [] for u in K4_SWEEP_UNROLLS}
        for r in range(rounds):
            k = r % len(K4_SWEEP_UNROLLS)
            for u in K4_SWEEP_UNROLLS[k:] + K4_SWEEP_UNROLLS[:k]:
                samples[u].append(cuda_ms(runs[u], reps))
        cells = "  ".join(
            f"U={programs[name, u].block_rows}: {np.mean(v):.4f} "
            f"({min(v):.4f}-{max(v):.4f})" for u, v in samples.items())
        print(f"[sweep] scan_group {name} L={SEG_L} n_ext={base.n_ext} "
              f"chain_ms={chain_ms:.4f}; ms mean (min-max): {cells}")
        # the chunk and the warm-up of the default block size, the walk
        # in series last; each held to the default's output first
        plans = {f"C={c} W={w}": (base, {"chunk": c, "warmup": w})
                 for c, w in K4_SWEEP_PLANS}
        plans["one chunk"] = (base, {"chunk": SEG_L})
        other = "register blocks" if base.n_ext <= CG.STAGE_MAX_EXT \
            else "staged"
        plans[other] = (programs[name, "other"], {})
        for prog, kw in plans.values():
            check(same_values(SG.scan_group(prog, xs, c0, **kw), ref),
                  f"scan_group {name} {kw} differs from the default")
        times = {k: [] for k in plans}
        for r in range(rounds):
            for k, (prog, kw) in plans.items():
                times[k].append(cuda_ms(
                    lambda prog=prog, kw=kw: SG.scan_group(prog, xs, c0, **kw),
                    reps))
        print(f"[sweep] scan_group {name} L={SEG_L}, ms mean (min-max) by "
              "chunk C and warm-up W, and with the externals loaded the "
              "other way: "
              + "  ".join(
                  f"{k}: {np.mean(v):.4f} ({min(v):.4f}-{max(v):.4f})"
                  for k, v in times.items()))


def jsfx_phase(torch, cuda, rng, card):
    """The JSFX main path: the in-repo delay network, its 192-tap
    widening, a cross-fed network and two scan-group plugins through
    PluginInstance.render on
    60 s of stereo; returns the K2, K3 and K4 launch counts of each timed
    render, and K4's re-run steps in it."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.runtime.engine import DEFAULT_SEGMENT_LEN, PluginInstance
    from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio, null_test_plugin
    # carried state against the CPU render's: the golden's scalar contract
    from zorak_tpu_torch.verify.nulltest import SCALAR_EPS as CARRY_EPS

    check(DEFAULT_SEGMENT_LEN == SEG_L, "the default segment length moved")
    sec = MAIN_T / SR
    n1, n_gold = int(SR), 4800
    launches, reruns = {}, {}
    segments = -(-MAIN_T // SEG_L)
    # label, source, held to the golden, launches of (K2, K3, K4) a
    # segment: one K3 launch folds both channels' chains; the cross-fed
    # network's right ring is written from the left sum, so two
    for label, src, hold_golden, per_segment in (
            ("fallback", BP.FALLBACK_SRC, False, (1, 1, 0)),
            ("wide", BP.wide_delay_network(192), True, (1, 1, 0)),
            ("cross_fed", BP.cross_fed_delay_network(16), True, (1, 2, 0)),
            ("follower", SCAN_GROUP_SRC, True, (0, 0, 1)),
            ("stereo_followers", STEREO_FOLLOWERS_SRC, True, (0, 0, 1))):
        t_phase = time.perf_counter()
        prog = compile_plugin_source(src)
        inst = PluginInstance(prog, srate=SR)          # device None: the card
        check(inst.engine == "torch-vector" and inst.spec_error is None,
              f"{label}: engine {inst.engine} ({inst.spec_error})")
        levels = len(inst.kernel.scan_level_programs())
        check(levels == per_segment[2], f"{label}: {levels} scan levels")
        x = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
        t0 = time.perf_counter()
        inst.render(x)                                 # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        LS.LAUNCHES = RT.LAUNCHES = SG.LAUNCHES = 0
        for v in SG.RERUN_STEPS.values():
            v.zero_()
        out = []
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: out.append(inst.render(x)))
        wall = time.perf_counter() - t0
        launches[label] = {"linrec_scan": LS.LAUNCHES,
                           "ring_tap_sum": RT.LAUNCHES,
                           "scan_group": SG.LAUNCHES}
        reruns[label] = sum(int(v.item()) for v in SG.RERUN_STEPS.values())
        res = out[0]
        check(res.engine == "torch-vector", f"{label}: rendered by {res.engine}")
        check(res.details.get("dispatch") == "graph",
              f"{label}: the render ran as {res.details.get('dispatch')}")
        check(tuple(launches[label].values())
              == tuple(n * segments for n in per_segment),
              f"{label}: launches {launches[label]}, expected "
              f"{per_segment} a segment x {segments} segments")
        y = res.audio
        check(y.shape == (2, MAIN_T) and y.dtype == np.float32,
              f"{label}: output {y.shape} {y.dtype}")
        check(bool(np.isfinite(y).all()), f"{label}: output not finite")
        print(f"[main] JSFX {label} 60 s stereo: engine={res.engine} "
              f"device_ms={ms:.2f} wall_s={wall:.4f} "
              f"audio_s_per_s={sec / (ms / 1e3):.1f} "
              f"launches={launches[label]} segments={segments} "
              f"scan_group_rerun_steps={reruns[label]} "
              f"warm-up render (kernel builds included) {warm_s:.2f} s "
              f"card='{card}'")
        kern = inst.kernel
        x_dev = torch.from_numpy(x).to(cuda)
        kern.render_device(x_dev)
        dev_ms = cuda_ms(lambda: kern.render_device(x_dev), reps=3)
        print(f"[main] JSFX {label}: the kernel alone, audio already on the "
              f"card and left there, mean of 3: device_ms={dev_ms:.2f} "
              f"audio_s_per_s={sec / (dev_ms / 1e3):.1f}")
        events, by_name = profile_render(lambda: kern.render_device(x_dev),
                                         f"JSFX {label}", segments)
        traced_k3 = sum(n for name, (n, _us) in by_name.items()
                        if "ring_tap_sum" in name)
        print(f"[main] JSFX {label}: device events a segment {events}, K3 "
              f"launches a segment {per_segment[1]} (in the trace "
              f"{traced_k3} of {per_segment[1] * segments}) card='{card}'")
        k5_held(torch, f"JSFX {label}", kern, kernel_render(kern, x_dev),
                MAIN_T, card)

        # causal, so the first second stands alone: against the port's
        # CPU render (the doubling ladders in place of K2's order)
        y_cpu = PluginInstance(prog, srate=SR, device="cpu").render(
            x[:, :n1]).audio
        rep = compare_audio(y_cpu, y[:, :n1])
        print(f"[main] JSFX {label} first 1 s, CUDA vs CPU render: "
              f"{rep.summary()}")
        check(rep.audio_passed,
              f"{label}: CUDA render disagrees with CPU at {AUDIO_EPS}")
        gold = PluginInstance(prog, srate=SR, prefer="none", device="cpu")
        res_g = gold.render(x[:, :n_gold])
        check(res_g.engine == "cpu-shadow", "the golden did not render")
        rep = compare_audio(res_g.audio, y[:, :n_gold])
        print(f"[main] JSFX {label} first {n_gold} samples, CUDA vs the Python "
              f"golden: {rep.summary()}")
        if hold_golden:
            check(rep.audio_passed,
                  f"{label}: CUDA render disagrees with the golden")
        else:
            # the in-repo text leaves dT and gT unset, so both tap tables
            # alias mem[0..15], inside the left ring: the golden reads
            # audio where the planner folded constants.  The reference
            # package differs from its golden by the same amount; what
            # is held here is the port against its CPU render.
            rep_c = compare_audio(res_g.audio, y_cpu[:, :n_gold])
            check(rep_c.max_abs_delta == rep.max_abs_delta or
                  abs(rep_c.max_abs_delta - rep.max_abs_delta) < AUDIO_EPS,
                  f"{label}: CUDA and CPU renders differ from the golden "
                  "by different amounts")
        # the carries after 10 s (four segments, the speculated ones
        # included), scalars and rings, against the CPU render's
        n10 = 10 * int(SR)
        _y, (sv, rings) = kern.render_device(x_dev[:, :n10])
        _y, (sv_c, rings_c) = PluginInstance(
            prog, srate=SR, device="cpu").kernel.render(x[:, :n10])
        carry_err = 0.0
        for what, got, want in [("scalars", sv, sv_c)] + [
                (f"ring {r}", rings[r], a) for r, a in rings_c.items()]:
            got = got.cpu()
            check(torch.equal(torch.isnan(got), torch.isnan(want)),
                  f"{label}: carried {what} NaN elsewhere than the CPU's")
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
            carry_err = max(carry_err, err)
        check(carry_err <= CARRY_EPS, f"{label}: carries after 10 s differ "
              f"from the CPU render's by {carry_err:.3e}")
        print(f"[main] JSFX {label}: carries after 10 s (scalars and "
              f"{len(rings_c)} rings) against the CPU render's: max "
              f"|delta| {carry_err:.3e} (limit {CARRY_EPS})")
        # the whole 60 s render against the native C golden: audio, and
        # vars and heap at the end (null_test_plugin renders both)
        t_g = time.perf_counter()
        rep = null_test_plugin(prog, x, srate=SR, golden="native",
                               segment_len=SEG_L, device=cuda,
                               compare_mem=True)
        print(f"[main] JSFX {label} whole 60 s, CUDA vs the native golden: "
              f"{rep.summary()} ({time.perf_counter() - t_g:.1f} s)")
        if hold_golden:
            check(rep.passed, f"{label}: the 60 s render disagrees with the "
                  "native golden")
        else:
            print(f"[main] JSFX {label}: not held to the golden (its tap "
                  "tables alias the ring; ROADMAP queue 3)")
        print(f"[done] JSFX {label} in {time.perf_counter() - t_phase:.1f} s")

    k5_new_keys(torch, cuda, card)
    return launches, reruns


# a modular counter that wraps at a prime, so a step of 512 starts it at a
# new place mod 9,973 each time: every step of K5 a new key
NEW_KEYS_PRIME = 9973
NEW_KEYS_SRC = f"""@init
MASK = 1023;
@sample
buf[w & MASK] = spl0;
p += 1; p >= {NEW_KEYS_PRIME} ? p = 0;
spl0 = 0.5*spl0 + buf[(w - 300) & MASK] + p*1e-6;
w += 1;
"""
NEW_KEYS_L = 512
NEW_KEYS_STEPS = 900        # a turn; 4 turns stay below the prime


def k5_new_keys(torch, cuda, card):
    """K5 where no key comes back: NEW_KEYS_SRC in steps of 512, resumed
    render after render, so every step of the graph's renders is a key
    seen for the first time and runs uncaptured.  Times the renders in
    turns (eager, graph, graph, eager) and holds the graph's turns to no
    capture and no replay."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.lowering import specialize_sample_kernel
    from zorak_tpu_torch.verify import make_initialized_shadow

    prog = compile_plugin_source(NEW_KEYS_SRC)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    1, device=cuda, segment_len=NEW_KEYS_L)
    check(kern.k5_refusal is None and kern.L == NEW_KEYS_L,
          f"new keys: refusal {kern.k5_refusal}, segment {kern.L}")
    n = NEW_KEYS_STEPS * NEW_KEYS_L
    x = torch.from_numpy((np.random.RandomState(SEED + 22).randn(1, n)
                          * 0.25).astype(np.float32)).to(cuda)
    # builds and first allocations, on a carry of their own
    for step in ("eager", "graph"):
        kern._render_device_as(step, x[:, :4 * NEW_KEYS_L])
    _y, carry = kern._render_device_as("eager", x[:, :NEW_KEYS_L])
    st0 = kern._k5.stats()
    walls = {"eager": [], "graph": []}
    for step in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _y, carry = kern._render_device_as(step, x, carry)
        torch.cuda.synchronize()
        walls[step].append(time.perf_counter() - t0)
        check(step == "eager" or kern.dispatch == "graph",
              f"new keys: ran as {kern.dispatch}")
    st1 = kern._k5.stats()
    check(st1["captures"] == st0["captures"]
          and st1["replays"] == st0["replays"]
          and st1["uncaptured"] - st0["uncaptured"] == 2 * NEW_KEYS_STEPS,
          f"new keys: {st1['captures'] - st0['captures']} captures, "
          f"{st1['replays'] - st0['replays']} replays, "
          f"{st1['uncaptured'] - st0['uncaptured']} steps uncaptured of "
          f"{2 * NEW_KEYS_STEPS}")
    row = {"label": "new keys", "steps_a_turn": NEW_KEYS_STEPS,
           "L": NEW_KEYS_L, "turns_eager_s": walls["eager"],
           "turns_graph_s": walls["graph"],
           "eager_ms_a_step": 1e3 * min(walls["eager"]) / NEW_KEYS_STEPS,
           "graph_ms_a_step": 1e3 * min(walls["graph"]) / NEW_KEYS_STEPS,
           "card": card}
    K5_ROWS.append(row)
    print(f"[k5] new keys: {NEW_KEYS_STEPS} steps of {NEW_KEYS_L} a render, "
          f"resumed, every step of the graph's renders a key seen for the "
          f"first time (uncaptured, no capture, no replay); wall in turns: "
          f"eager {' '.join(f'{w:.4f}' for w in walls['eager'])}, graph "
          f"{' '.join(f'{w:.4f}' for w in walls['graph'])} s "
          f"({row['eager_ms_a_step']:.4f} against "
          f"{row['graph_ms_a_step']:.4f} ms a step) card='{card}'")
    return row


def verify_cli_phase(card):
    """The CLI's `verify` on the card (device None), native golden and an
    export bundle, on a one-entry catalog made in a temporary directory
    (the 192-tap widening, 2 s of stereo noise)."""
    import tempfile

    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.cli.main import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        leaf = Path(tmp) / "catalog" / "plugins" / "Delay" / "Wide"
        (leaf / "src").mkdir(parents=True)
        (leaf / "plugin.json").write_text(json.dumps({
            "name": "Wide delay network", "slug": "Wide",
            "pluginCode": "Zwid", "pluginType": "jsfx"}))
        (leaf / "src" / "Wide.jsfx").write_text(BP.wide_delay_network(192))
        bundle = Path(tmp) / "bundle"
        t0 = time.perf_counter()
        rc = cli_main(["verify", "--catalog", str(Path(tmp) / "catalog"),
                       "--seconds", "2", "--golden", "native",
                       "--export-dir", str(bundle)])
        names = sorted(p.name for p in bundle.iterdir())
        report = json.loads((bundle / "Wide_report.json").read_text())
    check(rc == 0 and report["passed"], f"CLI verify: rc {rc}, {report}")
    check(names == ["Wide_compiled.wav", "Wide_delta.wav", "Wide_report.json",
                    "Wide_shadow.wav"], f"CLI verify bundle: {names}")
    print(f"[verify] CLI verify --golden native --export-dir on the card: rc "
          f"{rc}, bundle {names}, max |delta| {report['max_abs_delta']:.3e} "
          f"({time.perf_counter() - t0:.1f} s) card='{card}'")


def batch_kernels_phase(torch, cuda, rng):
    """K3 and K4 with a files axis against their plain versions on the
    same CUDA inputs, and each file against the kernel's single-file
    launch, bit for bit (every NaN one value): 1, 3 and 8 files, other
    data and cursors a file, NaN in one file; for K4 the last file's
    burst into silence makes its fix-up walk again, which must mark that
    file's flag alone, as its single-file launch marks its own."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import ring_taps as RT, scan_group as SG
    from zorak_tpu_torch.runtime.engine import PluginInstance

    def T(v):
        return torch.from_numpy(np.asarray(v, dtype=np.float64)).to(cuda)

    cases = 0
    for nf in (1, 3, 8):
        for n in (1, 777, SEG_L):
            parts = [tap_case(rng, 192, 16384, n), tap_case(rng, 16, 4096, n),
                     tap_case(rng, 5, max(4096, 2 * n), n, long_only=True)]
            rings = [rng.randn(nf, len(r)) for r, *_ in parts]
            rings[0][nf - 1, ::97] = np.nan       # NaN in the last file
            # a stream a file, one stream for all files, history alone;
            # inits a value a file, a stream a file, one float
            streams = [T(rng.randn(nf, n)), T(parts[1][1]), None]
            inits = [T(rng.randn(nf, 1)), T(rng.randn(nf, n)), 0.25]
            cursors = [16383, 1000, 2048]
            for tile in (None, RT.TILES[0], RT.TILES[-1]):
                tables = RT.TapTables([(st, g) for _r, _s, st, g in parts],
                                      cuda, tile, n, files=nf)
                args = (tables, [T(r) for r in rings], cursors, streams,
                        inits, n)
                got = RT.ring_tap_sum(*args)
                ref = RT.ring_tap_sum_reference(*args)
                what = f"ring_tap_sum files={nf} L={n} tile={tables.tile}"
                check(got.shape == (3, nf, n), f"{what}: {tuple(got.shape)}")
                check(same_values(got, ref), f"{what} differs from its plain "
                      "fold")
                for f in range(nf):
                    one = RT.ring_tap_sum(
                        tables, [r[f] for r in args[1]], cursors,
                        [s if s is None or s.dim() == 1 else s[f]
                         for s in streams],
                        [i[f] if isinstance(i, torch.Tensor) else i
                         for i in inits], n)
                    check(same_values(got[:, f], one),
                          f"{what}: file {f} differs from its own launch")
                cases += 1
    torch.cuda.synchronize()
    print(f"[batch] ring_tap_sum with files 1, 3, 8 x L 1, 777, {SEG_L} x "
          f"three tiles: {cases} cases bit-identical to the plain fold and "
          "to each file's own launch (NaN in one file)")

    small = {"chunk": 64, "warmup": 256}   # many chunks, many re-runs
    key = str(torch.zeros(0, device=cuda).device)     # the flags' key
    for name in ("follower", "stereo_followers",
                 "group_feeding_from_vectorized_delay"):
        src, _nch = K4_BODIES[name]
        levels = PluginInstance(compile_plugin_source(src),
                                srate=SR).kernel.scan_level_programs()
        base = levels[min(levels)][2]

        def fresh():
            # flags of its own; the library is the same text's, built once
            return SG.ScanGroupProgram(base.steps, base.outs, base.n_ext)

        def reruns_of(fn):
            for v in SG.RERUN_STEPS.values():
                v.zero_()
            out = fn()
            torch.cuda.synchronize()
            return out, sum(int(v.item()) for v in SG.RERUN_STEPS.values())

        for nf in (1, 3, 8):
            for n in (4096, SEG_L):
                xs = rng.randn(nf, n, base.n_ext) * 0.5
                if nf > 1 and base.n_ext:
                    xs[1, n // 3, 0] = -0.0
                    xs[1, 3 * n // 4, -1] = np.nan
                xs[nf - 1, n // 10:] = 0.0           # a burst into silence
                xs = T(xs)
                c0 = T(rng.uniform(0.1, 0.9, (nf, base.n_carry)))
                ref = (SG.scan_group_plain(base.steps, base.outs, xs, c0)
                       if n <= 4096 else None)
                for kw in ({}, small):
                    program = fresh()
                    launches = SG.LAUNCHES
                    got, reruns = reruns_of(
                        lambda: SG.scan_group(program, xs, c0, **kw))
                    check(SG.LAUNCHES == launches + 1,
                          f"scan_group {name}: {SG.LAUNCHES - launches} "
                          "launches for one batch")
                    marks = [int(v) for v in program._flags[(key, nf)][0]]
                    what = f"scan_group {name} files={nf} L={n} {kw or ''}"
                    if ref is not None:
                        check(same_values(got, ref),
                              f"{what} differs from its plain loop")
                    solo_reruns, solo_marks = 0, []
                    for f in range(nf):
                        alone = fresh()
                        one, r = reruns_of(lambda: SG.scan_group(
                            alone, xs[f], c0[f], **kw))
                        check(same_values(got[f], one),
                              f"{what}: file {f} differs from its own launch")
                        solo_reruns += r
                        solo_marks += [int(v) for v in
                                       alone._flags[(key, 1)][0]]
                    check(reruns == solo_reruns and marks == solo_marks,
                          f"{what}: re-runs {reruns} flags {marks}, each file "
                          f"alone {solo_reruns} {solo_marks}")
                    if name == "group_feeding_from_vectorized_delay" and kw:
                        check(marks == [-1] * (nf - 1) + [1],
                              f"{what}: flags {marks}, the silent file's alone "
                              "expected")
                    print(f"[batch] {what}: bit-identical to "
                          f"{'the plain loop and ' if ref is not None else ''}"
                          f"each file's own launch, re-run steps {reruns} "
                          f"(each file alone: {solo_reruns}), flags {marks}")


def kernel_bounds(kern, label, nf, seg, per_segment, segments):
    """(kernel, trace name tag, launches a render, (bound ms, by)) of K2,
    K3 and K4 in a render of nf files at segment length seg: each input
    read and each output written once at the HBM rate, or K3's two f64
    instructions a tap and sample."""
    out = []
    if per_segment[0]:
        # the one-pole wave: nf x 2 rows, a scalar a; b read, z written
        rows = nf * 2
        out.append(("linrec_scan", "linrec_", per_segment[0] * segments,
                    bound_ms(16 * rows * seg, 0.0)))
    if per_segment[1]:
        launches = kern.tap_launches(seg, nf)
        taps = sum(sum(g.tables.counts) for g in launches)
        nbytes = 12 * taps
        for g in launches:
            for st, m in zip(g.tables.starts, g.members):
                mod = m.region[1]
                end = min(max(st) + seg, mod + (seg if m.needs_src else 0))
                nbytes += 8 * nf * (end - min(st) + seg)
        # a DMUL and a DADD a tap and sample, at the f64 instruction rate
        ops_ms = 2 * taps * seg * nf / F64_INSTR_PER_S * 1e3 / len(launches)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3 / len(launches)
        out.append(("ring_tap_sum", "ring_tap_sum",
                    per_segment[1] * segments,
                    (max(ops_ms, bytes_ms),
                     "operations" if ops_ms > bytes_ms else "bytes")))
    if per_segment[2]:
        ((_k, ext, program, _i),) = kern.scan_level_programs().values()
        out.append(("scan_group", "zs_", per_segment[2] * segments,
                    bound_ms(8 * nf * seg * (len(ext) + program.n_carry),
                             0.0)))
    return out


def held_at_the_batch_shapes(torch, label, src, seg, x, y, per_segment,
                             segment):
    """K2, K3 and K4 at the shapes a batch render gives them: a fresh
    BatchRenderer renders x through the eager step (K5's replays call no
    wrapper) with the wrappers' calls of one segment
    recorded (the inputs copied before the launch, the kernel's output
    kept), and each recorded launch is held bit for bit (every NaN one
    value) to its plain version on those same CUDA inputs: K2 to
    `linrec_chunked`, the NumPy mirror of its order, K3 to
    `ring_tap_sum_reference`, K4 to `scan_group_plain` (within
    K4_LIBM_TOL where its body calls the device's libm).  The render must
    equal y (a render through K5)."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.parallel import BatchRenderer

    def copied(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, (list, tuple)):
            return type(v)(copied(u) for u in v)
        return v

    wrappers = [(LS, "linrec_scan", per_segment[0]),
                (RT, "ring_tap_sum", per_segment[1]),
                (SG, "scan_group", per_segment[2])]
    calls = {name: [] for _m, name, _n in wrappers}
    seen = dict.fromkeys(calls, 0)

    def spy(mod, name, fn, per):
        def run(*args):
            i = seen[name]
            seen[name] += 1
            if per * segment <= i < per * (segment + 1):
                kept = copied(args)
                out = fn(*args)
                calls[name].append((kept, out))
                return out
            return fn(*args)
        setattr(mod, name, run)

    kept_fns = [(mod, name, getattr(mod, name)) for mod, name, _n in wrappers]
    try:
        for (mod, name, per), (_m, _n, fn) in zip(wrappers, kept_fns):
            spy(mod, name, fn, per)
        # a fresh renderer: its segment program binds the recording
        # wrappers; the eager step calls them (a replay calls none)
        br = BatchRenderer(compile_plugin_source(src), SR, segment_len=seg)
        again = br._render_as("eager", x)
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in kept_fns:
            setattr(mod, name, fn)
    check(torch.equal(again, y), f"batch {label}: the recorded render differs")
    shapes = []
    for name, rec in calls.items():
        per = dict((n, p) for _m, n, p in wrappers)[name]
        check(len(rec) == per, f"batch {label}: {len(rec)} {name} calls "
              f"recorded in segment {segment}, {per} expected")
        for args, got in rec:
            what = f"batch {label} {name} segment {segment}"
            if name == "linrec_scan":
                a, b, z0 = (v.cpu().numpy() for v in args)
                ref = torch.from_numpy(LS.linrec_chunked(a, b, z0))
                check(same_values(got.cpu(), ref),
                      f"{what} differs from linrec_chunked")
                shapes.append(f"K2 rows {tuple(b.shape)}")
            elif name == "ring_tap_sum":
                ref = RT.ring_tap_sum_reference(*args)
                check(same_values(got, ref), f"{what} differs from its plain "
                      "fold")
                shapes.append(f"K3 {tuple(got.shape)} "
                              f"taps {list(args[0].counts)}")
            else:
                # the plain loop (70 to 110 us a step) on the first and
                # the last file's first K4_BATCH_HELD_T steps: K4 is causal
                program, xs, c0 = args
                files = sorted({0, xs.shape[0] - 1})
                n_t = min(xs.shape[1], K4_BATCH_HELD_T)
                got = got[files, :n_t]
                ref = SG.scan_group_plain(program.steps, program.outs,
                                          xs[files, :n_t].contiguous(),
                                          c0[files].contiguous())
                if program.transcendental:
                    check(bool((torch.isnan(got) == torch.isnan(ref)).all())
                          and float((got - ref).nan_to_num().abs().max())
                          <= K4_LIBM_TOL, f"{what} differs from its plain "
                          f"loop by more than {K4_LIBM_TOL}")
                else:
                    check(same_values(got, ref),
                          f"{what} differs from its plain loop")
                shapes.append(f"K4 xs {tuple(xs.shape)} (held on files "
                              f"{files}, {n_t} steps)")
    return shapes


def batch_phase(torch, cuda, rng, card):
    """The JSFX batch path: BatchRenderer on 8 files x 60 s of stereo at
    the bench's segment through the 192-tap widening, the cross-fed
    network and the two scan-group plugins (each file equal to its solo
    render on the card, K2, K3 and K4 launched as often as for one file,
    times, a profiler pass); the catalog functions on a temporary catalog,
    CUDA against CPU; then the config-1 figures of
    zorak_tpu_torch/bench.py.  Returns the batched launches of the
    widening (K2, K3) and of the follower (K4)."""
    import tempfile

    from zorak_tpu_torch import bench
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.kernels import switching_scan as SS
    from zorak_tpu_torch.parallel import (
        BatchRenderer, build_catalog_renderers, catalog_batch_render,
        catalog_stacked_render)
    from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio

    def counts():
        return {"linrec_scan": LS.LAUNCHES, "ring_tap_sum": RT.LAUNCHES,
                "scan_group": SG.LAUNCHES, "switching_scan": SS.LAUNCHES}

    def zero():
        LS.LAUNCHES = RT.LAUNCHES = SG.LAUNCHES = SS.LAUNCHES = 0

    nf, n, seg = bench.DDT_FILES, bench.DDT_SAMPLES, bench.DDT_SEG
    segments = -(-n // seg)
    sec = n / SR
    gen = torch.Generator(device=cuda)
    launches = {}
    for label, src, per_segment in (
            ("wide", BP.wide_delay_network(192), (1, 1, 0)),
            ("cross_fed", BP.cross_fed_delay_network(16), (1, 2, 0)),
            ("follower", SCAN_GROUP_SRC, (0, 0, 1)),
            ("stereo_followers", STEREO_FOLLOWERS_SRC, (0, 0, 1))):
        t_phase = time.perf_counter()
        br = BatchRenderer(compile_plugin_source(src), SR, segment_len=seg)
        kern = br.kernel
        check(kern.device.type == "cuda", f"batch {label}: on {kern.device}")
        gen.manual_seed(int(rng.randint(1 << 30)))
        x = torch.randn((nf, 2, n), generator=gen, device=cuda) * 0.25
        br.render_files(x)                               # warm-up
        kern.render_device(x[0])
        zero()
        y = br.render_files(x)
        torch.cuda.synchronize()
        batched = counts()
        zero()
        kern.render_device(x[0])
        torch.cuda.synchronize()
        solo = counts()
        want = {"linrec_scan": per_segment[0] * segments,
                "ring_tap_sum": per_segment[1] * segments,
                "scan_group": per_segment[2] * segments, "switching_scan": 0}
        check(batched == solo == want, f"batch {label}: launches {batched} "
              f"for {nf} files, {solo} for one, {want} expected")
        launches[label] = batched
        check(y.shape == (nf, 2, n) and y.dtype == torch.float32,
              f"batch {label}: output {tuple(y.shape)} {y.dtype}")
        check(bool(torch.isfinite(y).all()), f"batch {label}: not finite")
        for f in range(nf):
            one, _carry = kern.render_device(x[f])
            check(torch.equal(y[f], one),
                  f"batch {label}: file {f} differs from its solo render")
        t0 = time.perf_counter()
        shapes = held_at_the_batch_shapes(torch, label, src, seg, x, y,
                                          per_segment, segments // 2)
        print(f"[batch] {label}: segment {segments // 2}'s launches at the "
              f"batch's shapes ({'; '.join(shapes)}) bit-identical to their "
              f"plain versions on the same inputs "
              f"({time.perf_counter() - t0:.1f} s)")
        # in turns: one file, the batch, the batch, one file, twice
        batch_ms, one_ms = [], []
        for _ in range(2):
            one_ms.append(cuda_ms(lambda: kern.render_device(x[0])))
            batch_ms += [cuda_ms(lambda: br.render_files(x)) for _ in range(2)]
            one_ms.append(cuda_ms(lambda: kern.render_device(x[0])))
        ms, solo_ms = min(batch_ms), min(one_ms)
        print(f"[batch] JSFX {label} {nf} files x 60 s stereo, segment {seg} "
              f"({segments} segments): device_ms={ms:.2f} (best of "
              f"{' '.join(f'{m:.2f}' for m in batch_ms)}) audio_s_per_s="
              f"{nf * sec / (ms / 1e3):.1f} per_file_rtx="
              f"{sec / (ms / 1e3):.1f}; one file alone {solo_ms:.2f} ms "
              f"(best of {' '.join(f'{m:.2f}' for m in one_ms)}; x{nf} = "
              f"{nf * solo_ms:.2f}), the batch {ms / solo_ms:.2f}x one "
              f"file's; launches {batched} for {nf} files = one file's; "
              f"every file torch.equal to its solo render card='{card}'")
        _events, by_name = profile_render(lambda: br.render_files(x),
                                          f"batch {label} {nf} files",
                                          segments)
        _events, by_name_one = profile_render(
            lambda: kern.render_device(x[0]), f"batch {label} one file",
            segments, traces=1)
        # each kernel's device time a launch at the batch's shapes, from
        # the traces, beside one file's and the bytes or operations bound
        for kname, tag, n_launch, bound in kernel_bounds(
                kern, label, nf, seg, per_segment, segments):
            def per_launch(names):
                us = sum(t for name, (_n, t) in names.items() if tag in name)
                return us / 1e3 / n_launch
            print(f"[batch] {kname} in the {label} render, {nf} files: "
                  f"{per_launch(by_name):.4f} ms a launch (one file "
                  f"{per_launch(by_name_one):.4f}), bound {bound[0]:.5f} ms "
                  f"({bound[1]}) card='{card}'")
        k5_held(torch, f"batch {label} {nf} files", kern,
                batch_render(br, x), n, card)
        print(f"[done] batch {label} in {time.perf_counter() - t_phase:.1f} s")

    # the catalog functions on the card against the CPU: two Faust
    # modules (VAR runs K1), and three JSFX plugins (K2, K3, K4)
    leaves = {("Restoration", "VAR"): ("faust", "process = _, _;\n"),
              ("Dynamics", "GTS"): ("faust", "process = _, _;\n"),
              ("Delay", "Wide"): ("jsfx", BP.wide_delay_network(192)),
              ("Delay", "Cross"): ("jsfx", BP.cross_fed_delay_network(16)),
              ("Dynamics", "Follow"): ("jsfx", SCAN_GROUP_SRC)}
    x = (rng.randn(2, int(SR)) * 0.25).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "catalog"
        for (category, slug), (ptype, text) in leaves.items():
            leaf = root / "plugins" / category / slug
            (leaf / "src").mkdir(parents=True)
            (leaf / "plugin.json").write_text(json.dumps({
                "name": slug, "slug": slug, "pluginCode": "Z" + slug[:3],
                "pluginType": ptype}))
            ext = ".dsp" if ptype == "faust" else ".jsfx"
            (leaf / "src" / f"{slug}{ext}").write_text(text)
        renderers, skipped = build_catalog_renderers(str(root),
                                                     segment_len=SEG_L)
        zero()
        outs, _ = catalog_batch_render(str(root), x, renderers=renderers)
        torch.cuda.synchronize()
        got = counts()
        check(not skipped and sorted(outs) == sorted(s for _c, s in leaves),
              f"catalog: {sorted(outs)}, skipped {skipped}")
        check(all(v > 0 for v in got.values()),
              f"catalog_batch_render skipped a kernel: {got}")
        outs_cpu, _ = catalog_batch_render(str(root), x, segment_len=SEG_L,
                                           device="cpu")
        stacked, n_groups = catalog_stacked_render(renderers, x)
    worst = 0.0
    for slug, y in outs.items():
        check(y.device.type == "cuda", f"catalog {slug} on {y.device}")
        rep = compare_audio(outs_cpu[slug][0].numpy(), y[0].cpu().numpy())
        check(rep.audio_passed, f"catalog {slug}: CUDA vs CPU {rep.summary()}")
        check(torch.equal(stacked[slug], y[0]),
              f"catalog {slug}: the stacked render differs from the batch")
        worst = max(worst, rep.max_abs_delta)
    print(f"[batch] catalog_batch_render on the card, {len(outs)} entries: "
          f"launches {got}; each within {AUDIO_EPS} of its CPU render (max "
          f"|delta| {worst:.3e}); catalog_stacked_render in {n_groups} "
          f"group(s), equal to it card='{card}'")

    t0 = time.perf_counter()
    figures = {**bench.section_ddt(cuda), **bench.section_ddt_batched(cuda)}
    print(f"[batch] bench config 1 (zorak_tpu_torch/bench.py, the 192-tap "
          f"widening, 60 s stereo): {json.dumps(figures)} "
          f"({time.perf_counter() - t0:.1f} s) card='{card}'")
    return {"linrec_scan": launches["wide"]["linrec_scan"],
            "ring_tap_sum": launches["wide"]["ring_tap_sum"],
            "scan_group": launches["follower"]["scan_group"]}


COUPLED_FFT = 2048      # the stand-in's FFT (spectral_tilt_leveler)
COUPLED_FILES = 8
COUPLED_FILES_T = 2_880_000   # the coupled batch, 8 files x 60 s
COUPLED_THREADS = (128, 256, 512, 1024)   # K10's thread sweep


def coupled_phase(torch, cuda, rng, card):
    """The audio-coupled @block: K10 (block_section) against its plain
    version and, bit for bit, against its earlier design (thread 0 alone)
    at the first and a middle block of 1 and 8 files, the two designs in
    turns, the thread sweep, the probes; then spectral_tilt_leveler
    through PluginInstance.render on 60 s of stereo, held to the native
    golden; returns K10's `kernels` entry."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build
    from zorak_tpu_torch.kernels import block_section as BS
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.parallel import BatchRenderer
    from zorak_tpu_torch.runtime.engine import PluginInstance
    from zorak_tpu_torch.verify import AUDIO_EPS, SCALAR_EPS

    sec = MAIN_T / SR
    n_fft = COUPLED_FFT
    spec = slice(2 * n_fft, 3 * n_fft)      # the plugin's FFT buffer
    prog = compile_plugin_source(BP.spectral_tilt_leveler(n_fft))
    inst = PluginInstance(prog, srate=SR)
    kern = inst.kernel
    check(inst.engine == "torch-vector" and kern.coupled,
          f"coupled: engine {inst.engine} ({inst.spec_error})")
    B = kern.B
    blocks = -(-MAIN_T // B)
    k10 = kern._block_prog
    phases = [(ph.kind, ph.label) for ph in k10.block.phases]
    check([k for k, _l in phases] == ["serial", "loop", "fft", "fft",
                                      "serial"],
          f"coupled: K10's phases {phases}")
    print(f"[coupled] K10's phases: {phases}; kept on thread 0: "
          f"{k10.block.serial_loops}; {BS.barriers_a_launch(k10)} barriers "
          f"a launch; {k10.threads} threads")

    def like(threads, probe=False):
        return BS.BlockSectionProgram(k10.block, k10.slider, k10.n_svec,
                                      k10.inter, k10.regions, k10.cells,
                                      k10.ctrl, probe=probe, threads=threads)
    probe = like(k10.threads, probe=True)   # the earlier design, the probes
    sweep = {n: (k10 if n == k10.threads else like(n))
             for n in COUPLED_THREADS}
    t0 = time.perf_counter()
    logs = _build.build_generated([k10.source, probe.source]
                                  + [p.source for p in sweep.values()])
    print(f"[coupled] K10, its probe build (the earlier design) and the "
          f"thread sweep's {len(sweep)} builds built together in "
          f"{time.perf_counter() - t0:.2f} s")
    for label, source in [("block_section", k10.source),
                          ("block_section probe build", probe.source)]:
        for line in logs[source].splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"[build] {label}: {line.strip()}")

    def run_on(fn, program, rec):
        """fn (block_section or its earlier design) on a copy of rec's
        inputs: (svec, rings, bvars, bmem, ctrl, mout) after it."""
        out = rec.copy()
        ctrl, mout = out.run(fn, program)
        torch.cuda.synchronize()
        return [out.svec, out.rings, out.bvars, out.bmem, ctrl, mout]

    def held(label, rec):
        """K10 on the card against its earlier design (vars, heap with the
        FFT buffer, the exchanges, control row and MIDI out bit for bit)
        and against its plain version on the same inputs (the exchanges
        and the heap outside the FFT buffer bit for bit, the FFT buffer,
        vars and control row within FFT_TOL_REL); returns (max |delta|
        from the plain version, the plain version's ms)."""
        new = run_on(BS.block_section, k10, rec)
        old = run_on(BS.block_section_earlier, probe, rec)
        names = ("svec", "rings", "vars", "heap", "control row", "MIDI out")
        for name, a, b in zip(names, new, old):
            pairs = zip(a, b) if name == "rings" else [(a, b)]
            check(all((x is None and y is None) or same_values(x, y)
                      for x, y in pairs),
                  f"K10 {label}: {name} differs from the earlier design")
        cpu = rec.copy("cpu")
        t_p = time.perf_counter()
        ctrl_p, _ = cpu.run(BS.block_section_plain, k10)
        plain_ms = (time.perf_counter() - t_p) * 1e3
        check(same_values(new[0].cpu(), cpu.svec) and all(
            same_values(a.cpu(), b) for a, b in zip(new[1], cpu.rings)),
            f"K10 {label}: the sample side differs from the plain version")
        heap, heap_p = new[3].cpu(), cpu.bmem
        off = ~(heap == heap_p)
        off[:, spec] = False
        check(not bool(off.any()), f"K10 {label}: heap cells outside the "
              "FFT buffer differ from the plain version")
        vals = torch.cat([new[2].cpu(), new[4].cpu()], dim=1)
        vals_p = torch.cat([cpu.bvars, ctrl_p], dim=1)
        excess = BS.fft_excess(heap, heap_p, vals, vals_p)
        errs = [float((heap - heap_p).abs().max()),
                float((vals - vals_p).abs().max())]
        check(excess <= 0.0, f"K10 {label}: heap {errs[0]:.3e}, vars and "
              f"control row {errs[1]:.3e} from the plain version, beyond "
              f"FFT_TOL_REL {BS.FFT_TOL_REL}")
        print(f"[coupled] K10 {label} (samplesblock {rec.sb:g}): "
              f"bit-identical "
              f"to the earlier design (vars, heap and FFT buffer, "
              f"exchanges, control row); against the plain version the exchanges and "
              f"the heap outside the FFT buffer bit-identical, the FFT "
              f"buffer within {errs[0]:.3e} (of max "
              f"{float(heap_p.abs().max()):.3e}), vars and control row "
              f"within {errs[1]:.3e}; plain version {plain_ms:.1f} ms")
        return max(errs), plain_ms

    def in_turns(inputs, reps=50):
        """(the earlier design's ms, K10's ms) a launch, timed old, new,
        new, old on the same inputs (changed in place: each launch a
        block)."""
        _p, svec, rings, bvars, bmem, sb, _st = inputs
        runs = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            fn, p = (BS.block_section_earlier, probe) if which == "old" \
                else (BS.block_section, k10)
            runs[which].append(cuda_ms(
                lambda: fn(p, svec, rings, bvars, bmem, sb), reps=reps))
        BS.LAUNCHES = 0
        return runs["old"], runs["new"]

    x = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
    x_dev = torch.from_numpy(x).to(cuda)
    mid = blocks // 2
    # a 1 s warm-up render (the kernels' first loads), then the main path,
    # which also records K10's inputs at the first and the middle block
    # (the two records' clones fall inside its timed window): counts
    # zeroed just before, read just after
    t0 = time.perf_counter()
    inst.render(x[:, :int(SR)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # K10's inputs at the first and the middle block, recorded through
    # the eager step up to the middle block (a K5 replay calls no
    # wrapper): K5's yardstick
    n_rec = (mid + 1) * B
    got, spy, real = k10_recording({0, mid})
    BS.block_section = spy
    t0 = time.perf_counter()
    try:
        y_eager, _c = kern._render_device_as("eager", x_dev[:, :n_rec])
        torch.cuda.synchronize()
    finally:
        BS.block_section = real
    eager_s = time.perf_counter() - t0
    BS.zero_serial_runs()
    BS.LAUNCHES = LS.LAUNCHES = RT.LAUNCHES = 0
    out = []
    t0 = time.perf_counter()
    ms = cuda_ms(lambda: out.append(inst.render(x)))
    wall = time.perf_counter() - t0
    launches = {"block_section": BS.LAUNCHES, "linrec_scan": LS.LAUNCHES,
                "ring_tap_sum": RT.LAUNCHES}
    serial = BS.serial_runs(cuda)
    res = out[0]
    check(res.engine == "torch-vector", f"coupled: rendered by {res.engine}")
    check(res.details.get("dispatch") == "graph",
          f"coupled: the render ran as {res.details.get('dispatch')}")
    check(torch.equal(torch.from_numpy(res.audio[:, :n_rec]), y_eager.cpu()),
          "coupled: the render through K5 differs from the eager step's")
    check(launches["block_section"] == blocks
          and launches["ring_tap_sum"] == blocks
          and launches["linrec_scan"] > 0
          and launches["linrec_scan"] % blocks == 0,
          f"coupled: launches {launches} for {blocks} blocks")
    check(serial == 0, f"coupled: K10 ran the window loop on thread 0 "
          f"{serial} times")
    more_ms = sorted(cuda_ms(lambda: inst.render(x)) for _ in range(2))
    y = res.audio
    check(y.shape == (2, MAIN_T) and bool(np.isfinite(y).all()),
          "coupled: output not finite or of the wrong shape")
    print(f"[main] coupled spectral_tilt_leveler({n_fft}) 60 s stereo: "
          f"engine={res.engine} device_ms={ms:.2f} wall_s={wall:.4f} "
          f"audio_s_per_s={sec / (ms / 1e3):.2f} launches={launches} "
          f"blocks={blocks} ({launches['linrec_scan'] // blocks} K2 a block)"
          f" block loops on thread 0: {serial}; 1 s warm-up render "
          f"(builds included) {warm_s:.2f} s; two more renders "
          f"{' '.join(f'{m:.2f}' for m in more_ms)} ms; through K5, "
          f"torch.equal to the eager step's render of its first "
          f"{n_rec / SR:.1f} s ({eager_s:.2f} s of wall) card='{card}'")

    # the native golden on the same 60 s, timed alone; the render above
    # (the instance's audio and its state after the writeback) held to it
    rep, gold_s = held_to_native_golden(prog, x, y, inst.shadow.state, B)
    print(f"[main] coupled whole 60 s, PluginInstance.render on the card vs "
          f"the native golden (audio {AUDIO_EPS}, vars and heap "
          f"{SCALAR_EPS}): {rep.summary()}; the golden alone "
          f"{gold_s:.2f} s on the host ({sec / gold_s:.2f} audio s per s)")
    check(rep.passed, "coupled: the 60 s render disagrees with the native "
          "golden")

    # K10 against the earlier design and its plain version at the first
    # and the middle block
    err1, _ = held("1 file, block 0", got[0])
    err2, plain_ms = held(f"1 file, block {mid}", got[mid])

    # K10 alone at the middle block's inputs: the two designs in turns,
    # the thread sweep, and the probes
    inputs = got[mid]
    old_ms, new_ms = in_turns(inputs)
    k10_ms = sum(new_ms) / len(new_ms)
    _p, svec, rings, bvars, bmem, sb, _st = inputs
    sweep_ms = {}
    for n, p in sweep.items():
        BS.block_section(p, svec, rings, bvars, bmem, sb)       # loads it
        sweep_ms[n] = cuda_ms(lambda: BS.block_section(
            p, svec, rings, bvars, bmem, sb), reps=50)
    BS.LAUNCHES = 0
    print(f"[coupled] K10 a launch, 1 file, block {mid}'s inputs, mean of "
          f"50, in turns: earlier design {old_ms[0] * 1e3:.1f}, K10 "
          f"{new_ms[0] * 1e3:.1f}, K10 {new_ms[1] * 1e3:.1f}, earlier "
          f"{old_ms[1] * 1e3:.1f} us; thread sweep "
          + ", ".join(f"{n}: {v * 1e3:.1f}" for n, v in sweep_ms.items())
          + f" us card='{card}'")
    reps = 20
    names = BS.fft_probe_names(probe)
    which = names.index(f"fft_real({n_fft})")
    BS.block_section_chain_probe(probe, bvars, bmem, sb, 1)    # first launch
    BS.block_section_chain_probe(probe, bvars, bmem, sb, 1, ordered_only=True)
    BS.block_section_fft_probe(probe, bvars, bmem, which, 1)   # loads each
    chain_ms = cuda_ms(lambda: BS.block_section_chain_probe(
        probe, bvars, bmem, sb, reps)) / reps
    ordered_ms = cuda_ms(lambda: BS.block_section_chain_probe(
        probe, bvars, bmem, sb, reps, ordered_only=True)) / reps
    fft_ms = cuda_ms(lambda: BS.block_section_fft_probe(
        probe, bvars, bmem, which, reps)) / reps
    fft_block_ms = cuda_ms(lambda: BS.block_section_fft_probe(
        probe, bvars, bmem, which, reps, block=True)) / reps
    sig = torch.randn((COUPLED_FILES, n_fft), dtype=torch.float64,
                      device=cuda)
    rfft_ms = {}
    for nf in (1, COUPLED_FILES):
        torch.fft.rfft(sig[:nf])                 # cuFFT's plan, uncounted
        rfft_ms[nf] = cuda_ms(lambda: torch.fft.rfft(sig[:nf]), reps=50)
    # the ordered chain: the band loop kept on thread 0, per iteration its
    # compare (k < LOW), its add into lo or hi and k += 1, three dependent
    # f64 operations, and each other top-level statement of thread 0 one;
    # at a dependent add's latency, plus the barriers at theirs
    lat = torch.zeros(1, dtype=torch.float64, device=cuda)
    n_lat = 1 << 16
    BS.block_section_latency_probe(probe, lat, 16)
    BS.block_section_latency_probe(probe, lat, 16, barriers=True)
    add_ns = cuda_ms(lambda: BS.block_section_latency_probe(
        probe, lat, n_lat)) * 1e6 / n_lat
    bar_ns = cuda_ms(lambda: BS.block_section_latency_probe(
        probe, lat, n_lat, barriers=True)) * 1e6 / n_lat
    block_phases = sum(ph.kind != "serial" for ph in k10.block.phases)
    chain_ops = 3 * (n_fft // 2) + len(k10.block.body) - block_phases - 1
    n_bar = BS.barriers_a_launch(k10)
    chain_bound = (chain_ops * add_ns + n_bar * bar_ns) / 1e6
    n_inter, ring_cells = len(k10.inter), sum(m for _o, m in k10.regions)
    nbytes = 8 * (2 * (n_inter + ring_cells + len(k10.cells))
                  + len(k10.ctrl) + 2 * k10.n_vars + 3 * n_fft)
    ops = 5 * n_fft * int(np.log2(n_fft)) + 3 * n_fft
    b_ms, b_by = bound_ms(nbytes, ops)
    print(f"[coupled] probes: the sections alone on one thread "
          f"{chain_ms * 1e3:.1f} us; thread 0's ordered code alone "
          f"{ordered_ms * 1e3:.1f} us; fft_real({n_fft}) on one thread "
          f"{fft_ms * 1e3:.1f} us, in block form on {probe.threads} threads "
          f"{fft_block_ms * 1e3:.2f} us; torch.fft.rfft [1, {n_fft}] f64 "
          f"{rfft_ms[1] * 1e3:.2f} us, [{COUPLED_FILES}, {n_fft}] "
          f"{rfft_ms[COUPLED_FILES] * 1e3:.2f} us; a dependent f64 add "
          f"{add_ns:.2f} ns, a barrier of {probe.threads} threads "
          f"{bar_ns:.2f} ns; chain bound {chain_bound * 1e3:.2f} us "
          f"({chain_ops} dependent operations, {n_bar} barriers); bytes and "
          f"operations bound {b_ms * 1e3:.4f} us by {b_by} ({nbytes} bytes, "
          f"{ops} f64 operations) card='{card}'")

    # one traced render of 10 s: the device idle share
    n10 = 10 * int(SR)
    _events, by_name = profile_render(
        lambda: kern.render_device(x_dev[:, :n10]), "coupled 10 s",
        traces=1)
    busy_ms = sum(us for _n, us in by_name.values()) / 1e3
    k10_traced = [(n, us) for name, (n, us) in by_name.items()
                  if "zb_kernel" in name]
    traced = {}
    if k10_traced:
        n, us = k10_traced[0]
        traced = {"traced_launches": n, "traced_k10_us": us / n,
                  "traced_k10_share": us / 1e3 / busy_ms,
                  "traced_busy_ms_a_block": busy_ms / n}
        print(f"[coupled] K10 in the trace: {n} launches, {us / n:.1f} us a "
              f"launch, {us / 1e3 / busy_ms:.3f} of the busy time; busy "
              f"{busy_ms / n:.4f} ms a block")
    k5_1 = k5_held(torch, f"coupled spectral_tilt_leveler({n_fft})", kern,
                   kernel_render(kern, x_dev), n10, card,
                   turns_T=5 * int(SR))

    # 8 files: the batch render of 60 s beside one file's, K10 at the
    # batch's first and middle blocks (held, and the two designs in
    # turns); every file of a 2 s batch equal to its solo render
    x8 = torch.from_numpy((rng.randn(COUPLED_FILES, 2, COUPLED_FILES_T)
                           * 0.25).astype(np.float32)).to(cuda)
    mid8 = -(-COUPLED_FILES_T // B) // 2
    br = BatchRenderer(prog, srate=SR)
    br.render_files(x8[:, :, :B])                    # stage and warm up
    n8_rec = (mid8 + 1) * B
    got8, spy, real = k10_recording({0, mid8})
    BS.block_section = spy
    try:
        # the wrappers' calls, up to the middle block
        y8_eager = br._render_as("eager", x8[:, :, :n8_rec])
    finally:
        BS.block_section = real
    check(torch.equal(br.render_files(x8)[:, :, :n8_rec], y8_eager),
          "coupled batch: the render through K5 differs from the eager "
          "step's")
    batch_ms = cuda_ms(lambda: br.render_files(x8))
    solo_ms = cuda_ms(lambda: br.kernel.render_device(x8[0]))
    err3, _ = held(f"{COUPLED_FILES} files, block 0", got8[0])
    err4, plain8_ms = held(f"{COUPLED_FILES} files, block {mid8}",
                           got8[mid8])
    old8_ms, new8_ms = in_turns(got8[mid8])
    k10_8_ms = sum(new8_ms) / len(new8_ms)
    n2 = 2 * int(SR)
    y8 = br.render_files(x8[:, :, :n2])
    for f in range(COUPLED_FILES):
        solo, _ = br.kernel.render_device(x8[f, :, :n2])
        check(torch.equal(y8[f], solo),
              f"coupled batch: file {f} differs from its solo render")
    k5_8 = k5_held(torch, f"coupled spectral_tilt_leveler({n_fft}) "
                   f"{COUPLED_FILES} files", br.kernel, batch_render(br, x8),
                   n2, card)
    serial_all = BS.serial_runs(cuda)
    check(serial_all == 0, f"coupled: K10 ran a block loop on thread 0 "
          f"{serial_all} times in the phase")
    print(f"[coupled] K10 a launch, {COUPLED_FILES} files, in turns: "
          f"earlier {old8_ms[0] * 1e3:.1f}, K10 {new8_ms[0] * 1e3:.1f}, K10 "
          f"{new8_ms[1] * 1e3:.1f}, earlier {old8_ms[1] * 1e3:.1f} us "
          f"({k10_8_ms / k10_ms:.2f}x one file's); batch of "
          f"{COUPLED_FILES} x {COUPLED_FILES_T / SR:.0f} s: {batch_ms:.2f} ms "
          f"beside one file's {solo_ms:.2f} ms; every file of a 2 s batch "
          f"torch.equal to its "
          f"solo render; block loops on thread 0 in the phase: "
          f"{serial_all} card='{card}'")
    return {
        "name": "block_section", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/block_ops.cuh",
        "replaces": "zorak_tpu/lowering/devgen.py:463",
        "launches": launches["block_section"],
        "max_abs_err": max(err1, err2, err3, err4), "ms": k10_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "threads": k10.threads,
        "earlier_ms": sum(old_ms) / len(old_ms), "turns_ms": {
            "earlier": old_ms, "new": new_ms},
        "sweep_ms": sweep_ms, "ms_8_files": k10_8_ms,
        "earlier_ms_8_files": sum(old8_ms) / len(old8_ms),
        "plain_ms_8_files": plain8_ms,
        "chain_bound_ms": chain_bound, "chain_ops": chain_ops,
        "barriers": n_bar, "add_ns": add_ns, "barrier_ns": bar_ns,
        "chain_ms": chain_ms, "ordered_ms": ordered_ms, "fft_ms": fft_ms,
        "fft_block_ms": fft_block_ms, "fft_library_ms": rfft_ms,
        "serial_runs": serial, "render_ms": ms, "render_more_ms": more_ms,
        "golden_s": gold_s, "batch_ms": batch_ms, "solo_ms": solo_ms,
        "blocks": blocks, **traced,
        "k5_ms_a_block": k5_1["graph_ms_a_step"],
        "k5_eager_ms_a_block": k5_1["eager_ms_a_step"],
        "k5_ms_a_block_8_files": k5_8["graph_ms_a_step"],
        "launches_linrec_scan": launches["linrec_scan"],
        "launches_ring_tap_sum": launches["ring_tap_sum"],
    }


GATED_LINES, GATED_BUF = 8, 8192   # builtin_plugins.gated_fdn_tank
GATED_T = 2_880_000   # the gated render, 60 s through K5's replays
GATED_K5_T = 240_000  # the eager step beside it, 5 s: host-paced
HOP_PART, HOP_PARTS = 1024, 8       # builtin_plugins.hop_convolver
# guessed loop(n) bounds: @block's count runs 3 to 9, the guess starts at 2
LADDER_SRC = ("@block\nr = r + 1; r > 9 ? r = 3;\n@sample\nacc = 0;\n"
              "loop(r, acc = acc * 0.5 + spl0;);\nspl1 = acc * 0.3;\n")
LADDER_K0 = 2
# K2 launches a segment of the tank: its plan's two waves of recurrences
# (25 rows a file with a per-sample a, the values held and filtered inside
# the gate, then 1)
GATED_K2_PER_SEGMENT = 2
# K6's and K3b's launches a segment of the tank: one K6a for the gate's
# readers (a gringidx, eight gringrefs, the cursor's stream and carry), one
# K6b for the gated rand() site, one K6c for the eight rings' writes, and
# a K3b gather for each of the eight dynamic taps
GATED_K6_PER_SEGMENT = {"gated_cursor": 1, "gated_draws": 1,
                        "gated_ring_write": 1, "dyn_ring_read": 8}


def held_to_native_golden(prog, x, y, state, B=512, midi=None, trace=None,
                          host=None, gmem=False):
    """The native golden's render of x (blocks of B, with the host's MIDI
    events where given, the host services of `host`) against audio y and
    the state after a writeback: a NullReport (audio 1e-5, vars and heap
    1e-8) and the golden's seconds, and where `trace` names a var, its
    value after each block; where `gmem`, last the largest difference
    between the two states' gmem (held to 1e-8 by the caller)."""
    from zorak_tpu_torch.shadow import compile_native_shadow
    from zorak_tpu_torch.shadow.state import MidiEvent
    from zorak_tpu_torch.verify import apply_slider_state, compare_audio
    from zorak_tpu_torch.verify.nulltest import (compare_memory_pages,
                                                 compare_states)

    gold = compile_native_shadow(prog, host=host)
    gold.state.srate = SR
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y_gold = np.zeros_like(x)
    queues = {}
    for ev in sorted(midi or [], key=lambda e: e[0]):
        start = int(ev[0]) // B * B
        queues.setdefault(start, []).append(MidiEvent(
            int(ev[0]) - start, int(ev[1]) & 0xFF, int(ev[2]) & 0xFF,
            int(ev[3]) & 0xFF))
    traced_values = []
    t0 = time.perf_counter()
    for start in range(0, x.shape[1], B):
        if midi is not None:
            gold.state.midi_in = queues.get(start, [])
            gold.state.midi_in_pos = 0
        gold.process_block(x[:, start:start + B], y_gold[:, start:start + B])
        if trace is not None:
            traced_values.append(gold.state.V.get(trace, 0.0))
    gold_s = time.perf_counter() - t0
    rep = compare_audio(y_gold, y)
    compare_states(gold.state, state, report=rep)
    compare_memory_pages(gold.state, state, report=rep)
    out = (rep, gold_s)
    if trace is not None:
        out += (np.asarray(traced_values),)
    if gmem:
        out += (float(np.abs(np.asarray(gold.state.gmem, dtype=np.float64)
                             - np.asarray(state.gmem)).max()),)
    return out


def batch_equals_solo(torch, label, prog, x8):
    """BatchRenderer on the files x8 [nf, 2, T] on the card: each file
    torch.equal to its solo render; returns (the batch's audio, batch ms,
    one file's ms)."""
    from zorak_tpu_torch.parallel import BatchRenderer

    br = BatchRenderer(prog, srate=SR)
    br.render_files(x8[:, :, :1024])                 # stage and warm up
    y8 = []
    batch_ms = cuda_ms(lambda: y8.append(br.render_files(x8)))
    solo_ms = None
    for f in range(x8.shape[0]):
        out = []
        ms = cuda_ms(lambda: out.append(br.kernel.render_device(x8[f])))
        solo_ms = ms if solo_ms is None else solo_ms
        check(torch.equal(y8[0][f], out[0][0]),
              f"{label} batch: file {f} differs from its solo render")
    return y8[0], batch_ms, solo_ms


def gi_copied(torch, v):
    """The tensors of a wrapper's arguments cloned, the rest as it is."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(gi_copied(torch, u) for u in v))
    if isinstance(v, (list, tuple)):
        return type(v)(gi_copied(torch, u) for u in v)
    return v


def gi_tensors(v):
    """The tensors of a wrapper's output, in order (None kept)."""
    if isinstance(v, (list, tuple)):
        return [t for u in v for t in gi_tensors(u)]
    return [v]


def gi_recorded(torch, label, src, seg, x, y, per_segment, segment):
    """K6's and K3b's wrappers at the shapes and on the inputs a render
    gives them: a fresh BatchRenderer renders x [files, ch, T] through the
    eager step (a replay calls no wrapper) with each wrapper's calls of
    segment `segment` recorded (the inputs copied before the launch, the
    output kept); the render must equal y.  Returns [(wrapper, args,
    keywords, output)] in the order the segment made them."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import gated_index as GI
    from zorak_tpu_torch.parallel import BatchRenderer

    calls = []
    seen = dict.fromkeys(GI_COUNTERS, 0)
    real = {name: getattr(GI, name) for _c, name in GI_WRAPPERS}

    def spy(counter, name):
        fn, per = real[name], per_segment[counter]

        def run(*args, **kw):
            i = seen[counter]
            seen[counter] += 1
            if per * segment <= i < per * (segment + 1):
                kept = (gi_copied(torch, args), gi_copied(torch, kw))
                out = fn(*args, **kw)
                calls.append((name, kept[0], kept[1], out))
                return out
            return fn(*args, **kw)
        return run

    try:
        for counter, name in GI_WRAPPERS:
            setattr(GI, name, spy(counter, name))
        # a fresh renderer: its segment program binds the recording wrappers
        br = BatchRenderer(compile_plugin_source(src), SR, segment_len=seg)
        again = br._render_as("eager", x)
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(GI, name, fn)
    check(torch.equal(again, y), f"{label}: the recorded render differs")
    got = dict.fromkeys(GI_COUNTERS, 0)
    for name, *_rest in calls:
        got[dict((n, c) for c, n in GI_WRAPPERS)[name]] += 1
    check(got == per_segment, f"{label}: segment {segment}'s calls {got}, "
          f"{per_segment} expected")
    return calls


def gi_bytes(name, args, kw, out) -> int:
    """The bytes a K6 or K3b call must move: each input read once (a gated
    ring's row, a gathered array only at the cells its outputs take, one a
    sample) and each output written once."""
    import torch

    def nbytes(t):
        return t.numel() * t.element_size() if isinstance(
            t, torch.Tensor) else 0

    outs = gi_tensors(out)
    moved = sum(nbytes(t) for t in outs)
    if name in ("gated_cursor", "gated_draws", "gated_ring_write"):
        moved += nbytes(args[0]) if name != "gated_draws" else sum(
            nbytes(g) for g in args[0])
        moved += nbytes(args[1])                    # a device anchor
    if name == "gated_cursor":
        # a value reader reads a cell a sample and file (its output)
        moved += sum(nbytes(o) for r, o in zip(args[2], outs)
                     if r.kind == "value")
    elif name == "gated_draws":
        moved += nbytes(outs[0])                    # the pool's cells
    elif name == "gated_ring_write":
        moved += sum(nbytes(ring) + nbytes(value)
                     for ring, value, _o, _m in args[2])
    elif name == "dyn_ring_read":
        src, slot = args[0], args[1]
        moved += nbytes(slot) + nbytes(outs[0])     # the slot, the cells
        moved += sum(nbytes(v) for v in kw.values()) + sum(
            nbytes(v) for v in args[4:])            # cursor, same
    return moved


def gi_held(torch, calls, what, timed):
    """Each recorded call's output held bit for bit (every NaN one value)
    to its plain version on the same CUDA inputs; where `timed`, each call
    timed as the kernel (`graph_ms`: 20 launches in a CUDA graph) and as
    its plain version (eager, by CUDA events), and its bound from
    `gi_bytes`.  A comparison: the counters are left as they were.
    Returns {wrapper: {calls, ms, plain_ms, bound_ms, max_abs_err}}, the
    times summed over the calls."""
    from zorak_tpu_torch.kernels import gated_index as GI

    rows = {}
    saved = gi_counts()
    try:
        for name, args, kw, out in calls:
            plain = getattr(GI, f"{name}_plain")
            ref = plain(*args, **kw)
            err = 0.0
            for a, b in zip(gi_tensors(out), gi_tensors(ref)):
                check((a is None) == (b is None) and (a is None or (
                    a.dtype == b.dtype and (same_values(a, b)
                                            if a.is_floating_point()
                                            else torch.equal(a, b)))),
                      f"{what}: {name} differs from its plain version")
                if a is not None and a.numel():
                    err = max(err, float((a.double() - b.double()).abs()
                                         .nan_to_num().max()))
            row = rows.setdefault(name, {"calls": 0, "ms": 0.0,
                                         "plain_ms": 0.0, "bound_ms": 0.0,
                                         "max_abs_err": 0.0})
            row["calls"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if timed:
                kernel = getattr(GI, name)
                row["ms"] += graph_ms(lambda: kernel(*args, **kw))
                plain(*args, **kw)
                row["plain_ms"] += cuda_ms(lambda: plain(*args, **kw),
                                           reps=20)
                row["bound_ms"] += bound_ms(gi_bytes(name, args, kw, out),
                                            0.0)[0]
    finally:
        gi_set_counts(saved)
    return rows


def gi_line(rows, card) -> str:
    return "; ".join(
        f"{name} x{r['calls']}: {r['ms']:.5f} ms against plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms"
        for name, r in rows.items()) + f" card='{card}'"


def gated_phase(torch, cuda, rng, card):
    """The gated regime: builtin_plugins.gated_fdn_tank through
    PluginInstance.render on GATED_T (60 s) of stereo (the segment length
    the plan
    cut, K2's and K6's launches, the render held to the native golden and
    its first second to the port's CPU render, a profiler pass with K6's
    share), the masked-loop ladder on 10 s from K = 2, and 8 files through
    BatchRenderer, K2's launches of a middle segment of 1 and of 8 files
    held to `linrec_chunked` on the same inputs, and K6's and the tank's
    K3b launches there held to their plain versions and timed; returns
    K2's launches in the render and K6's entry of the `kernels` line."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.lowering import specialize as SP
    from zorak_tpu_torch.runtime.engine import PluginInstance
    from zorak_tpu_torch.verify import AUDIO_EPS, SCALAR_EPS, compare_audio

    sec = GATED_T / SR
    n1, n10 = int(SR), 10 * int(SR)
    src = BP.gated_fdn_tank(GATED_LINES, GATED_BUF)
    prog = compile_plugin_source(src)
    x = (rng.randn(2, GATED_T) * 0.25).astype(np.float32)
    t0 = time.perf_counter()
    PluginInstance(prog, srate=SR).render(x[:, :n1])     # warm-up, 1 s
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # the main path, on an instance of its own: a fresh render draws from
    # the snapshot's generator, which a render's writeback advances
    inst = PluginInstance(prog, srate=SR)
    kern = inst.kernel
    check(inst.engine == "torch-vector" and kern.rand_gated
          and len(kern.sym.gring_writes) == GATED_LINES
          and kern.plans[("var", "w")].kind == "gmodind",
          f"gated: engine {inst.engine} ({inst.spec_error})")
    L = kern.segment_length(GATED_T)
    segments = -(-GATED_T // L)
    check(L == 1024, f"gated: the plan's segment length is {L}")
    LS.LAUNCHES = RT.LAUNCHES = SG.LAUNCHES = 0
    gi_set_counts(dict.fromkeys(GI_COUNTERS, 0))
    out = []
    t0 = time.perf_counter()
    ms = cuda_ms(lambda: out.append(inst.render(x)))
    wall = time.perf_counter() - t0
    launches = {"linrec_scan": LS.LAUNCHES, "ring_tap_sum": RT.LAUNCHES,
                "scan_group": SG.LAUNCHES, **gi_counts()}
    res = out[0]
    y = res.audio
    check(res.engine == "torch-vector", f"gated: rendered by {res.engine}")
    check(res.details.get("dispatch") == "graph",
          f"gated: the render ran as {res.details.get('dispatch')}")
    check(launches == {"linrec_scan": GATED_K2_PER_SEGMENT * segments,
                       "ring_tap_sum": 0, "scan_group": 0,
                       **{k: n * segments
                          for k, n in GATED_K6_PER_SEGMENT.items()}},
          f"gated: launches {launches} for {segments} segments, "
          f"{GATED_K2_PER_SEGMENT} K2 and {GATED_K6_PER_SEGMENT} a segment "
          f"expected")
    check(y.shape == (2, GATED_T) and bool(np.isfinite(y).all()),
          "gated: output not finite or of the wrong shape")
    print(f"[gated] gated_fdn_tank({GATED_LINES}, {GATED_BUF}) "
          f"{GATED_T / SR:.0f} s stereo: "
          f"engine={res.engine} segment length {L} (taps 1,500 to 4,000 "
          f"cells behind the cursor in rings of {GATED_BUF}), {segments} "
          f"segments; device_ms={ms:.2f} wall_s={wall:.4f} "
          f"audio_s_per_s={sec / (ms / 1e3):.2f} launches={launches} "
          f"({launches['linrec_scan'] / segments:.2f} K2 a segment, "
          f"{sum(launches[k] for k in GI_COUNTERS) / segments:.2f} K6 and "
          f"K3b); 1 s warm-up render {warm_s:.2f} s card='{card}'")
    rep, gold_s = held_to_native_golden(prog, x, y, inst.shadow.state)
    print(f"[gated] whole {GATED_T / SR:.0f} s, PluginInstance.render on "
          f"the card vs the "
          f"native golden (audio {AUDIO_EPS}, vars and heap {SCALAR_EPS}): "
          f"{rep.summary()}; the golden alone {gold_s:.2f} s")
    check(rep.passed, "gated: the render disagrees with the native "
          "golden")
    y_cpu = PluginInstance(prog, srate=SR, device="cpu").render(
        x[:, :n1]).audio
    rep = compare_audio(y_cpu, y[:, :n1])
    print(f"[gated] first 1 s, CUDA vs CPU render: {rep.summary()}")
    check(rep.audio_passed, "gated: CUDA render disagrees with the CPU's")

    # K6's share of a traced 1 s render's busy device time: the device
    # time of the kernels launched inside the emitter's K6 ranges (gate
    # masks, prefix sums, cursor arithmetic, the gathers, the gated
    # scatter), against every kernel's (about 1,200 device events a
    # segment: the trace's own processing grows with them)
    # the eager step: a K5 replay opens no range
    x_dev = torch.from_numpy(x).to(cuda)
    t_tr = time.perf_counter()
    events = traced(lambda: kern._render_device_as("eager", x_dev[:, :n1]))
    kernels = device_kernels(events)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    # the kernels launched inside each range; a range's own device record
    # is its span on the card, gaps included, and is not counted
    ranges, k6_kernels = range_kernels(events, SP.K6_RANGE)
    k6_us = sum(k.time_range.elapsed_us() for k in k6_kernels)
    span_own_us = sum(k.duration for r in ranges for k in r.kernels)
    k6_share = k6_us / busy_us if busy_us else None
    k2_us = sum(e.time_range.elapsed_us() for e in kernels
                if "linrec" in e.name)
    if kernels:
        span_us = (max(e.time_range.end for e in kernels)
                   - min(e.time_range.start for e in kernels))
        check(ranges and k6_us > 0, f"gated: the trace's {len(ranges)} K6 "
              f"ranges hold no device time")
        print(f"[profile] gated 1 s render: {len(kernels)} device events "
              f"({len(kernels) / -(-n1 // L):.1f} a segment), busy "
              f"{busy_us / 1e3:.2f} ms of a {span_us / 1e3:.2f} ms span, "
              f"idle share {1.0 - busy_us / span_us:.3f}")
    gi_us = sum(k.time_range.elapsed_us() for k in kernels
                if any(part in k.name for fam, part in K5_FAMILIES
                       if fam in GI_COUNTERS))
    print(f"[gated] K6 (the kernels launched inside the emitter's "
          f"{SP.K6_RANGE} ranges: K6a, K6b, K6c and the taps' K3b "
          f"gathers; {gi_us / 1e3:.3f} ms by their names): "
          f"{k6_us / 1e3:.3f} ms of "
          f"{busy_us / 1e3:.3f} ms busy, share "
          + (f"{k6_share:.3f}" if k6_share is not None else "not measured")
          + f" ({len(ranges)} ranges, {len(k6_kernels)} kernels; the "
          f"ranges' own spans on the card {span_own_us / 1e3:.3f} ms, not "
          f"counted); K2 {k2_us / 1e3:.3f} ms; the trace "
          f"took {time.perf_counter() - t_tr:.1f} s card='{card}'")
    k5 = k5_held(torch, f"gated_fdn_tank({GATED_LINES}, {GATED_BUF})", kern,
                 kernel_render(kern, x_dev), GATED_K5_T, card, turns_T=n1)
    print(f"[gated] K6 in the eager step: {k6_us / 1e3 / -(-n1 // L):.4f} "
          f"ms a segment of its {busy_us / 1e3 / -(-n1 // L):.4f} ms busy; "
          f"the same step replayed: {k5['graph_trace']['busy_ms']:.4f} ms "
          f"busy a segment card='{card}'")

    # the masked-loop ladder on the card: a guess of K = 2 for a count
    # that reaches 9, rebuilt and replayed on the same device
    t0 = time.perf_counter()
    lprog = compile_plugin_source(LADDER_SRC)
    os.environ["ZORAK_MASKED_LOOP_K"] = str(LADDER_K0)
    try:
        linst = PluginInstance(lprog, srate=SR)
    finally:
        del os.environ["ZORAK_MASKED_LOOP_K"]
    check(linst.engine == "torch-vector" and linst.kernel.sym.masked_loops
          and linst.kernel.masked_loop_k == LADDER_K0,
          f"ladder: engine {linst.engine} ({linst.spec_error})")
    rebuilds = [0]
    real = SP.specialize_sample_kernel

    def counted(*a, **k):
        rebuilds[0] += 1
        return real(*a, **k)

    SP.specialize_sample_kernel = counted
    try:
        lres = linst.render(x[:, :n10])
    finally:
        SP.specialize_sample_kernel = real
    lk = linst.kernel
    check(lres.engine == "torch-vector" and rebuilds[0] >= 1
          and lk.masked_loop_k >= 9 and lk.device.type == "cuda",
          f"ladder: {rebuilds[0]} rebuilds, K {lk.masked_loop_k}")
    rep, _s = held_to_native_golden(lprog, x[:, :n10], lres.audio,
                                    linst.shadow.state)
    print(f"[gated] masked-loop ladder, 10 s stereo from K = {LADDER_K0}: "
          f"{rebuilds[0]} rebuild(s), K = {lk.masked_loop_k}; vs the native "
          f"golden: {rep.summary()} ({time.perf_counter() - t0:.1f} s)")
    check(rep.passed, "ladder: the render disagrees with the native golden")

    # 8 files of 2 s through BatchRenderer, each its solo render
    x8 = torch.from_numpy((rng.randn(8, 2, 2 * n1) * 0.25).astype(np.float32)
                          ).to(cuda)
    y8, batch_ms, solo_ms = batch_equals_solo(torch, "gated", prog, x8)
    print(f"[gated] 8 files x 2 s through BatchRenderer: every file "
          f"torch.equal to its solo render; batch {batch_ms:.2f} ms, one "
          f"file {solo_ms:.2f} ms card='{card}'")
    # K2 at the shapes and inputs the gated path gives it (per-sample a,
    # g ? 0.6 : 1 and g ? 0 : 1), for 1 file and for 8
    middle = -(-x8.shape[2] // L) // 2
    for files in (1, 8):
        t0 = time.perf_counter()
        shapes = held_at_the_batch_shapes(
            torch, f"gated {files} file(s)", src, L, x8[:files], y8[:files],
            (GATED_K2_PER_SEGMENT, 0, 0), middle)
        print(f"[gated] {files} file(s): segment {middle}'s K2 launches "
              f"({'; '.join(shapes)}) bit-identical to linrec_chunked on "
              f"the same inputs ({time.perf_counter() - t0:.1f} s)")
    # K6 (K6a, K6b, K6c) and the tank's K3b gathers at the shapes and on
    # the inputs the path gives them, held bit for bit to their plain
    # versions on the card and timed
    held = {}
    for files in (1, 8):
        t0 = time.perf_counter()
        calls = gi_recorded(torch, f"gated {files} file(s)", src, L,
                            x8[:files], y8[:files], GATED_K6_PER_SEGMENT,
                            middle)
        held[files] = gi_held(torch, calls, f"gated {files} file(s)", True)
        print(f"[gated] {files} file(s): segment {middle}'s K6 and K3b "
              f"calls bit-identical to their plain versions on the same "
              f"inputs ({time.perf_counter() - t0:.1f} s); a segment: "
              + gi_line(held[files], card))
    # K6's least time a segment of one file: the gate mask, the pool's
    # draws and the rings read once, the rings, the draws and the cursor
    # positions written once, at the card's memory rate (the figure every
    # slice has stated); beside it, the sum of the kernels' own bounds
    # (`gi_bytes`: every reader's output, the taps' gathers too)
    k6_bytes = 4 * L * 8 + 2 * GATED_LINES * GATED_BUF * 8
    k6_bound = k6_bytes / HBM_BYTES_PER_S * 1e3
    k6_seg_ms = k6_us / 1e3 / -(-n1 // L)
    one = held[1]
    k6_ms = sum(r["ms"] for r in one.values())
    k6_plain_ms = sum(r["plain_ms"] for r in one.values())
    k6_calls_bound = sum(r["bound_ms"] for r in one.values())
    print(f"[gated] K6 a segment: {k6_seg_ms:.4f} ms in the traced 1 s "
          f"(the eager step), its {sum(GATED_K6_PER_SEGMENT.values())} "
          f"launches {k6_ms:.5f} ms each timed alone (plain "
          f"{k6_plain_ms:.4f} ms), bound {k6_bound:.6f} ms (bytes: "
          f"{k6_bytes}, the mask, draws and cursors of {L} samples and "
          f"{GATED_LINES} rings of {GATED_BUF} read and written once; the "
          f"launches' own bounds {k6_calls_bound:.6f} ms) card='{card}'")
    entry = {
        "name": "gated_index", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/gated_index.cu",
        "replaces": "zorak_tpu/lowering/specialize.py:4228",
        "launches": sum(launches[k] for k in GI_COUNTERS),
        "max_abs_err": max(r["max_abs_err"] for h in held.values()
                           for r in h.values()),
        "ms": k6_ms, "plain_ms": k6_plain_ms,
        "bound_ms": k6_calls_bound, "bound_by": "bytes",
        "library_ms": None,
        "launches_by_kernel": {k: launches[k] for k in GI_COUNTERS},
        "per_segment": GATED_K6_PER_SEGMENT,
        "kernels_ms": {k: r["ms"] for k, r in one.items()},
        "kernels_plain_ms": {k: r["plain_ms"] for k, r in one.items()},
        "kernels_bound_ms": {k: r["bound_ms"] for k, r in one.items()},
        "ms_8_files": sum(r["ms"] for r in held[8].values()),
        "plain_ms_8_files": sum(r["plain_ms"] for r in held[8].values()),
        "k6_share": k6_share, "k6_eager_ms_a_segment": k6_seg_ms,
        "k6_stated_bound_ms": k6_bound}
    return {"launches_gated": launches["linrec_scan"], "gated_segment": L,
            "gated_render_ms": ms, "k6_share": k6_share,
            "k6_bound_ms": k6_bound, "ladder_rebuilds": rebuilds[0],
            "gated_golden_s": gold_s,
            "k5_ms_a_segment": k5["graph_ms_a_step"],
            "k5_eager_ms_a_segment": k5["eager_ms_a_step"],
            "k6_entry": entry,
            "k3b_launches_gated": launches["dyn_ring_read"],
            "k3b_tank_ms": one["dyn_ring_read"]["ms"]
            / one["dyn_ring_read"]["calls"],
            "k3b_tank_plain_ms": one["dyn_ring_read"]["plain_ms"]
            / one["dyn_ring_read"]["calls"]}


def flat_phases(phases):
    """K10's phases depth first, a loop phase's body after it."""
    for ph in phases:
        yield ph
        yield from flat_phases(ph.body)


def phase_kinds(phases):
    """The phases' kinds, a loop phase as [kind, its body's kinds]."""
    return [[ph.kind, phase_kinds(ph.body)] if ph.body else ph.kind
            for ph in phases]


def hop_phase(torch, cuda, rng, card):
    """The hop pipeline: builtin_plugins.hop_convolver through
    PluginInstance.render on 60 s of stereo (a hop's step, its segment
    then K10 on the hop section, replayed by K5; the render held to the
    native golden and to the eager loop), K10 at the first and the middle
    hop against its earlier one-thread design (bit for bit) and its plain
    version, the two designs timed in turns beside the chain and bytes
    bounds, K5 held on 10 s (`k5_held`), and 8 files through
    BatchRenderer; returns K10's hop entries for the `kernels` line."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build
    from zorak_tpu_torch.kernels import block_section as BS
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.runtime.engine import PluginInstance
    from zorak_tpu_torch.verify import AUDIO_EPS, SCALAR_EPS

    sec = MAIN_T / SR
    n1 = int(SR)
    prog = compile_plugin_source(BP.hop_convolver(HOP_PART, HOP_PARTS))
    inst = PluginInstance(prog, srate=SR)
    kern = inst.kernel
    check(inst.engine == "torch-vector" and kern._hop is not None
          and kern._hop_len == HOP_PART,
          f"hop: engine {inst.engine} ({inst.spec_error})")
    check(kern.k5_refusal is None, f"hop: K5 refuses the plan: "
          f"{kern.k5_refusal}")
    hop = kern._hop_prog
    hops = MAIN_T // HOP_PART          # the counter starts at 0
    kinds = phase_kinds(hop.block.phases)
    every = list(flat_phases(hop.block.phases))
    block = [ph for ph in every if ph.kind != "serial"]
    check(hop.block.body and not hop.block.serial_loops
          and {ph.kind for ph in block} >= {"fft", "copy", "loop", "while"},
          f"hop: K10's phases {kinds}, kept on thread 0: "
          f"{hop.block.serial_loops}")
    print(f"[hop] the hop section: {len(hop.block.body)} top-level "
          f"statement(s), process() called as a statement and printed in "
          f"place as phases: {kinds} ({len(block)} block phases of "
          f"{len(every)}: {', '.join(ph.label for ph in block)}); heap "
          f"{hop.mem_size} cells, {len(hop.regions)} carried regions; "
          f"{hop.threads} threads")
    probe = BS.BlockSectionProgram(hop.block, hop.slider, hop.n_svec,
                                   hop.inter, hop.regions, hop.cells,
                                   hop.ctrl, probe=True, threads=hop.threads)
    t0 = time.perf_counter()
    logs = _build.build_generated([hop.source, probe.source])
    print(f"[hop] K10 and its probe build (the earlier one-thread design) "
          f"built together in {time.perf_counter() - t0:.2f} s")
    for label, source in [("block_section hop", hop.source),
                          ("block_section hop probe build", probe.source)]:
        for line in logs[source].splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"[build] {label}: {line.strip()}")
    x = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
    x_dev = torch.from_numpy(x).to(cuda)

    t0 = time.perf_counter()
    PluginInstance(prog, srate=SR).render(x[:, :n1])     # warm-up, 1 s
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # K10's inputs at the first and the middle hop, recorded through the
    # eager step up to the middle hop (a K5 replay calls no wrapper): the
    # main path's yardstick
    n_rec = (hops // 2 + 1) * HOP_PART
    got, spy, real = k10_recording({0, hops // 2})
    BS.block_section = spy
    t0 = time.perf_counter()
    try:
        y_eager, _c = kern._render_device_as("eager", x_dev[:, :n_rec])
        torch.cuda.synchronize()
    finally:
        BS.block_section = real
    eager_s = time.perf_counter() - t0

    # the main path: counts zeroed just before, read just after
    BS.zero_serial_runs()
    BS.LAUNCHES = LS.LAUNCHES = RT.LAUNCHES = 0
    out = []
    t0 = time.perf_counter()
    ms = cuda_ms(lambda: out.append(inst.render(x)))
    wall = time.perf_counter() - t0
    launches = BS.LAUNCHES
    serial = BS.serial_runs(cuda)
    res = out[0]
    y = res.audio
    check(res.engine == "torch-vector", f"hop: rendered by {res.engine}")
    check(res.details.get("dispatch") == "graph",
          f"hop: the render ran as {res.details.get('dispatch')}")
    check(launches == hops and LS.LAUNCHES == 0 and RT.LAUNCHES == 0,
          f"hop: K10 launched {launches} times for {hops} hops")
    check(serial == 0, f"hop: K10 ran a block loop or copy on thread 0 "
          f"{serial} times")
    check(torch.equal(torch.from_numpy(y[:, :n_rec]), y_eager.cpu()),
          "hop: the render through K5 differs from the eager step's")
    check(y.shape == (2, MAIN_T) and bool(np.isfinite(y).all()),
          "hop: output not finite or of the wrong shape")
    wet = float(np.abs(y - 0.5 * x).max())
    check(wet > 1e-3, f"hop: the convolution is silent ({wet})")
    more_ms = sorted(cuda_ms(lambda: inst.render(x)) for _ in range(2))
    print(f"[hop] hop_convolver({HOP_PART}, {HOP_PARTS}) 60 s stereo: "
          f"engine={res.engine} dispatch={res.details.get('dispatch')} "
          f"device_ms={ms:.2f} wall_s={wall:.4f} "
          f"audio_s_per_s={sec / (ms / 1e3):.2f} K10 launches {launches} "
          f"for {hops} hops (the replays' counts), block loops and copies "
          f"on thread 0: {serial}; two more renders "
          f"{' '.join(f'{m:.2f}' for m in more_ms)} ms; wet peak "
          f"{wet:.3f}; 1 s warm-up render {warm_s:.2f} s; through K5, "
          f"torch.equal to the eager step's render of its first "
          f"{n_rec / SR:.1f} s ({eager_s:.2f} s of wall) card='{card}'")
    rep, gold_s = held_to_native_golden(prog, x, y, inst.shadow.state)
    print(f"[hop] whole 60 s, PluginInstance.render on the card vs the "
          f"native golden (audio {AUDIO_EPS}, vars and heap {SCALAR_EPS}): "
          f"{rep.summary()}; the golden alone {gold_s:.2f} s")
    check(rep.passed, "hop: the 60 s render disagrees with the native golden")

    # K10 at the first and the middle hop: bit for bit to the earlier
    # one-thread design on the same inputs, and against its plain version
    # (the sample side's scalars and the hop's vars bit for bit, the heap
    # and the rings within FFT_TOL_REL: they hold the transforms' output)
    errs, plain_ms = [], None
    for i in sorted(got):
        new, old = got[i].copy(), got[i].copy()
        new.run(BS.block_section, hop)
        old.run(BS.block_section_earlier, probe)
        torch.cuda.synchronize()
        pairs = [("svec", new.svec, old.svec), ("vars", new.bvars, old.bvars),
                 ("heap", new.bmem, old.bmem)] + [
            (f"ring {j}", a, b) for j, (a, b) in enumerate(zip(new.rings,
                                                               old.rings))]
        for name, a, b in pairs:
            check(same_values(a, b), f"K10 hop {i}: {name} differs from the "
                  "earlier one-thread design")
        cpu = got[i].copy("cpu")
        t_p = time.perf_counter()
        cpu.run(BS.block_section_plain, hop)
        plain_ms = (time.perf_counter() - t_p) * 1e3
        check(same_values(new.svec.cpu(), cpu.svec)
              and same_values(new.bvars.cpu(), cpu.bvars),
              f"K10 hop {i}: scalars or vars differ from the plain version")
        ring, ring_p = torch.cat(new.rings, 1).cpu(), torch.cat(cpu.rings, 1)
        heap, bvars_k = new.bmem.cpu(), new.bvars.cpu()
        excess = max(BS.fft_excess(heap, cpu.bmem, bvars_k, cpu.bvars),
                     BS.fft_excess(ring, ring_p, bvars_k, cpu.bvars))
        err = max(float((heap - cpu.bmem).abs().max()),
                  float((ring - ring_p).abs().max()))
        errs.append(err)
        check(excess <= 0.0, f"K10 hop {i}: {err:.3e} from the plain "
              f"version, beyond FFT_TOL_REL {BS.FFT_TOL_REL}")
        print(f"[hop] K10 at hop {i}: svec, vars, heap and rings "
              f"bit-identical to the earlier one-thread design; against the "
              f"plain version scalars and vars bit-identical, heap and rings "
              f"within {err:.3e} (of max {float(cpu.bmem.abs().max()):.3e}); "
              f"plain version {plain_ms:.1f} ms")

    # K10 alone at the middle hop's inputs, the two designs in turns
    # (earlier, K10, K10, earlier; each launch a hop on the inputs it
    # changes)
    inputs = got[hops // 2]
    _p, svec, rings, bvars, bmem, sb, _st = inputs.copy()
    reps = 20
    turns = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        fn, p = (BS.block_section_earlier, probe) if which == "old" \
            else (BS.block_section, hop)
        turns[which].append(cuda_ms(
            lambda: fn(p, svec, rings, bvars, bmem, sb), reps=reps))
    BS.LAUNCHES = 0
    hop_ms = sum(turns["new"]) / len(turns["new"])
    old_ms = sum(turns["old"]) / len(turns["old"])
    serial = BS.serial_runs(cuda)
    check(serial == 0, f"hop: K10 ran a block loop or copy on thread 0 "
          f"{serial} times in the phase")
    # the chain bound: the barriers a launch passes (the exchanges' and the
    # phases', counted by the host form on the middle hop's inputs), each
    # after at least one dependent f64 operation, at the probes' latencies
    bars = []
    cpu = inputs.copy("cpu")
    BS.block_section_host(hop, cpu.svec, cpu.rings, cpu.bvars, cpu.bmem,
                          cpu.sb, threads=hop.threads, barriers=bars)
    n_bar = BS.barriers_a_launch(hop, bars[0])
    lat = torch.zeros(1, dtype=torch.float64, device=cuda)
    n_lat = 1 << 16
    BS.block_section_latency_probe(probe, lat, 16)
    BS.block_section_latency_probe(probe, lat, 16, barriers=True)
    add_ns = cuda_ms(lambda: BS.block_section_latency_probe(
        probe, lat, n_lat)) * 1e6 / n_lat
    bar_ns = cuda_ms(lambda: BS.block_section_latency_probe(
        probe, lat, n_lat, barriers=True)) * 1e6 / n_lat
    chain_bound = n_bar * (add_ns + bar_ns) / 1e6
    # the least time for a hop by bytes and operations: the exchanges (the
    # carried rings in and out, the vars in and out) and the section's heap
    # traffic (the input block, the partitions' spectra, the delay line and
    # the overlap read; the output ring, the overlap, the delay line and two
    # work buffers written) at the card's memory rate, beside two real
    # transforms of 2 * part, `parts` complex products and the
    # accumulation at its f64 rate
    n2 = 2 * HOP_PART
    ring_cells = sum(m for _o, m in hop.regions)
    nbytes = 8 * (2 * ring_cells + 2 * hop.n_vars
                  + (HOP_PART + 2 * HOP_PARTS * n2 + HOP_PART)
                  + (HOP_PART + HOP_PART + HOP_PARTS * n2 + 2 * n2))
    ops = (2 * (5 * HOP_PART * int(np.log2(HOP_PART)) + 4 * n2)
           + HOP_PARTS * 6 * HOP_PART + HOP_PARTS * n2 + 3 * HOP_PART)
    b_ms, b_by = bound_ms(nbytes, ops)
    print(f"[hop] K10 a hop, middle hop's inputs, mean of {reps} by CUDA "
          f"events, in turns: earlier one-thread design "
          f"{turns['old'][0] * 1e3:.1f}, K10 {turns['new'][0] * 1e3:.1f}, "
          f"K10 {turns['new'][1] * 1e3:.1f}, earlier "
          f"{turns['old'][1] * 1e3:.1f} us ({hops} hops: "
          f"{hop_ms * hops:.1f} ms of a render); chain bound "
          f"{chain_bound * 1e3:.2f} us ({n_bar} barriers a launch, "
          f"{bars[0]} of them the phases', each after a dependent f64 add: "
          f"{add_ns:.2f} ns, a barrier of {probe.threads} threads "
          f"{bar_ns:.2f} ns); bytes and operations bound "
          f"{b_ms * 1e3:.4f} us by {b_by} ({nbytes} bytes, {ops} f64 "
          f"operations); block loops and copies on thread 0: {serial} "
          f"card='{card}'")

    # K5 on the hop render: a hop's step replayed against the eager loop
    k5 = k5_held(torch, f"hop_convolver({HOP_PART}, {HOP_PARTS})", kern,
                 kernel_render(kern, x_dev), 10 * n1, card, turns_T=5 * n1)

    x8 = torch.from_numpy((rng.randn(8, 2, 2 * n1) * 0.25).astype(np.float32)
                          ).to(cuda)
    _y8, batch_ms, solo_ms = batch_equals_solo(torch, "hop", prog, x8)
    print(f"[hop] 8 files x 2 s through BatchRenderer: every file "
          f"torch.equal to its solo render; batch {batch_ms:.2f} ms, one "
          f"file {solo_ms:.2f} ms card='{card}'")
    return {"hop_launches": launches, "hop_ms": hop_ms,
            "hop_plain_ms": plain_ms, "hop_max_abs_err": max(errs),
            "hop_bound_ms": b_ms, "hop_bound_by": b_by,
            "hop_render_ms": ms, "hop_render_more_ms": more_ms,
            "hop_golden_s": gold_s,
            "hop_statements_thread0": sum(ph.kind == "serial"
                                          for ph in every),
            "hop_phases": kinds, "hop_block_phases": len(block),
            "hop_earlier_ms": old_ms,
            "hop_turns_ms": {"earlier": turns["old"], "new": turns["new"]},
            "hop_chain_bound_ms": chain_bound, "hop_barriers": n_bar,
            "hop_add_ns": add_ns, "hop_barrier_ns": bar_ns,
            "hop_serial_runs": serial,
            "hop_dispatch": res.details.get("dispatch"),
            "hop_k5_ms_a_step": k5["graph_ms_a_step"],
            "hop_k5_eager_ms_a_step": k5["eager_ms_a_step"],
            "hop_k5_host_ops": k5["graph_trace"]["host_ops"],
            "hop_batch_ms": batch_ms, "hop_solo_ms": solo_ms}


# the planner phase: the CPU tests' cases of tests/test_torch_planner_paths.py
PLANNER_RING_CYCLE = """\
@init
M = 512;
D = {delay};
A = 4096;
B = 8192;
@sample
ra = ia - D; ra < 0 ? ra += M;
rb = ib - D; rb < 0 ? rb += M;
A[ia] = spl0 + 0.5 * B[rb];
B[ib] = spl1 + 0.4 * A[ra];
spl0 = A[ia] - 0.25 * B[rb];
spl1 = B[ib];
ia += 1; ia >= M ? ia = 0;
ib += 1; ib >= M ? ib = 0;
"""
PLANNER_RAND_IN_BRANCH = \
    "@sample\nspl0 > 0 ? ( spl0 = rand(1) * 0.5; ) : ( spl0 *= 2; );\n"
PLANNER_SYSEX = """\
@init
p = 32; p[0] = 65; p[1] = 16; p[2] = 99;
cnt = 0;
@block
cnt += 1;
cnt == 2 ? midisyx(5, p, 3);
@sample
spl0 = spl0 * 0.5;
spl1 = spl1 * 0.5;
"""
# name -> (source, (channels, samples, scale, seed) of seeded noise (scale
# 0: silence), kernel options, the segment length a ring cycle cuts to)
PLANNER_CASES = {
    "ring_cycle_delay_300": (
        PLANNER_RING_CYCLE.format(delay=300), (2, 4000, 0.3, 3),
        {"block_size": 64, "segment_len": 4096}, 256),
    "ring_ring_cycle": (
        "@init\nbufA = 0; bufB = 4096;\n@sample\n"
        "ia += 1; ia >= 1024 ? ia = 0;\nib += 1; ib >= 1024 ? ib = 0;\n"
        "ra = ia - 600; ra < 0 ? ra += 1024;\n"
        "rb = ib - 700; rb < 0 ? rb += 1024;\n"
        "bufA[ia] = spl0 * 0.5 + bufB[rb] * 0.4;\n"
        "bufB[ib] = spl0 * 0.3 + bufA[ra] * 0.45;\n"
        "spl0 = bufA[ra] * 0.5 + bufB[rb] * 0.5;\n",
        (1, 5000, 0.4, 9), {"segment_len": 1 << 14}, 512),
    "modulated_delay": (
        "@init\nMASK = 1023;\n@sample\nbuf[w & MASK] = spl0;\n"
        "ph += 0.01;\nd = (40 + 30*sin(ph)) | 0;\n"
        "spl0 = 0.5*spl0 + 0.5*buf[(w - d) & MASK];\nw += 1;\n",
        (1, 5000, 0.4, 9), {"segment_len": 1024}, None),
    "signal_dependent_delay": (
        "@init\nMASK = 511;\n@sample\nbuf[w & MASK] = spl0;\n"
        "d = (10 + abs(spl1)*200) | 0;\nspl0 = buf[(w - d) & MASK];\n"
        "w += 1;\n", (2, 4000, 0.4, 9), {"segment_len": 512}, None),
    "wavetable_lookup": (
        "@init\ntab = 100;\n"
        "i = 0; loop(256, tab[i] = sin(i * $pi / 128); i += 1;);\n"
        "@sample\nph += 0.3 + 0.2*spl0;\nspl0 = tab[(ph | 0) & 255];\n",
        (1, 4000, 0.4, 9), {"segment_len": 1024}, None),
    "delay_crossing_segments": (
        "@init\nMASK = 255;\n@sample\nbuf[w & MASK] = spl0;\n"
        "d = 100 + ((w >> 5) & 63);\nspl0 = buf[(w - d) & MASK];\n"
        "w += 1;\n", (1, 2000, 0.4, 9), {"segment_len": 256}, None),
    "read_before_write_same_slot": (
        "@init\nMASK = 63;\n@sample\nold = buf[w & MASK];\n"
        "buf[w & MASK] = spl0;\nspl0 = old;\nw += 1;\n",
        (1, 500, 0.4, 9), {"segment_len": 128}, None),
    "rand_noise_source": (
        "@sample\nspl0 = rand(2) - 1;\n", (1, 3000, 0.0, 0),
        {"segment_len": 1024}, None),
    "rand_several_draws_a_sample": (
        "@sample\na = rand(1);\nb = rand(10);\n"
        "spl0 = a*0.1 + b*0.01 + spl0*0.5;\n", (1, 2000, 0.2, 0),
        {"segment_len": 512}, None),
    "rand_after_init_draws": (
        "@init\nseed_burn = rand(1) + rand(1);\n@sample\nspl0 = rand(1);\n",
        (1, 1500, 0.0, 0), {"segment_len": 512}, None),
    "rand_with_dynamic_limit": (
        "@sample\nlim = 1 + abs(spl0)*5;\nspl0 = rand(lim) * 0.1;\n",
        (1, 2000, 0.4, 1), {"segment_len": 512}, None),
    "rand_in_branch": (
        PLANNER_RAND_IN_BRANCH, (1, 1500, 0.4, 5), {"segment_len": 512},
        None),
    "rand_state_after_render": (
        "@sample\nspl0 = rand(1);\n", (1, 700, 0.0, 0),
        {"segment_len": 256}, None),
    "sysex_from_block": (
        PLANNER_SYSEX, (2, 2048, 0.25, 3),
        {"segment_len": 1024, "block_size": 512}, None),
}
PLANNER_CHORUS = (3, 4096)     # builtin_plugins.modulated_delay_chorus
# K3b's launches a segment of the chorus: each of its twelve dynamic reads
PLANNER_K3B_PER_SEGMENT = {"gated_cursor": 0, "gated_draws": 0,
                           "gated_ring_write": 0, "dyn_ring_read": 12}
PLANNER_DITHER_BITS = 16       # builtin_plugins.tpdf_dither


def planner_input(shape):
    nch, n, scale, seed = shape
    if not scale:
        return np.zeros((nch, n), np.float32)
    return (np.random.RandomState(seed).randn(nch, n) * scale).astype(
        np.float32)


def planner_cases(torch, cuda):
    """Every case of PLANNER_CASES rendered on the card and held to the
    native golden (audio, vars and heap) and to the port's CPU render;
    the ring cycles' segment lengths; the gated branch streamed over two
    resumed renders; the sub-block cycle on devexec.  Returns the largest
    audio difference from the golden."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.lowering import SpecializeError, specialize_sample_kernel
    from zorak_tpu_torch.shadow import compile_native_shadow
    from zorak_tpu_torch.verify import (
        SCALAR_EPS, compare_audio, make_initialized_shadow, null_test_plugin)
    from zorak_tpu_torch.verify.nulltest import apply_slider_state

    worst = 0.0
    for name, (src, shape, opts, seg) in PLANNER_CASES.items():
        opts = {"block_size": 512, **opts}
        prog = compile_plugin_source(src)
        x = planner_input(shape)
        kern = specialize_sample_kernel(
            prog, make_initialized_shadow(prog).state, shape[0], device=cuda,
            **opts)
        cpu = specialize_sample_kernel(
            prog, make_initialized_shadow(prog).state, shape[0],
            device="cpu", **opts)
        check(kern.L == cpu.L and (seg is None or kern.L == seg),
              f"planner {name}: segment length {kern.L} (CPU {cpu.L})")
        y, (svec, rings) = kern.render(x)
        y_c, (svec_c, rings_c) = cpu.render(x)
        rep = compare_audio(y_c, y)
        carry = max([np.abs(svec.cpu().numpy() - svec_c.numpy()).max(
            initial=0.0)] + [np.abs(rings[r].cpu().numpy() - a.numpy()).max(
                initial=0.0) for r, a in rings_c.items()])
        check(rep.audio_passed and carry <= SCALAR_EPS,
              f"planner {name}: CUDA vs CPU render {rep.summary()}, carry "
              f"{carry:.3e}")
        if name == "sysex_from_block":
            check(kern.last_midi_out == cpu.last_midi_out == [
                (517, 240, 65, 16, (240, 65, 16, 99, 247))],
                f"planner {name}: MIDI out {kern.last_midi_out}")
        gold = null_test_plugin(prog, x, golden="native", device=cuda,
                                compare_state=True, compare_mem=True, **opts)
        check(gold.passed, f"planner {name}: vs the native golden "
              f"{gold.summary()}")
        worst = max(worst, gold.max_abs_delta)
        print(f"[planner] {name}: L {kern.L}, CUDA vs CPU audio "
              f"{rep.max_abs_delta:.3e} carry {carry:.3e}; vs the native "
              f"golden (state and heap) {gold.summary()}")
    # the gated branch over two resumed renders, the generator rebased
    # between them
    prog = compile_plugin_source(PLANNER_RAND_IN_BRANCH)
    x = planner_input((1, 1400, 0.4, 6))
    gold = compile_native_shadow(prog)
    gold.state.srate = SR
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y_ref = np.zeros_like(x)
    for s in range(0, x.shape[1], 512):
        gold.process_block(x[:, s:s + 512], y_ref[:, s:s + 512])
    parts = []
    for dev in (cuda, "cpu"):
        kern = specialize_sample_kernel(
            prog, make_initialized_shadow(prog).state, 1, segment_len=512,
            device=dev)
        y1, carry = kern.render(x[:, :700])
        y2, carry = kern.render(x[:, 700:], carry)
        parts.append(np.concatenate([y1, y2], axis=1))
    rep, rep_c = compare_audio(y_ref, parts[0]), compare_audio(parts[1],
                                                               parts[0])
    check(rep.audio_passed and rep_c.audio_passed,
          f"planner streamed branch: vs the golden {rep.summary()}, vs CPU "
          f"{rep_c.summary()}")
    print(f"[planner] rand() in a branch over two resumed renders: vs the "
          f"native golden {rep.summary()}; vs CPU {rep_c.max_abs_delta:.3e}")
    # the sub-block coupling delay: refused by the vectorizer, rendered by
    # the sequential executor
    prog = compile_plugin_source(PLANNER_RING_CYCLE.format(delay=3))
    try:
        specialize_sample_kernel(prog, make_initialized_shadow(prog).state, 2,
                                 block_size=512, device=cuda)
        check(False, "planner: the sub-block ring cycle was not refused")
    except SpecializeError as exc:
        check("cyclic" in str(exc) or "coupling" in str(exc),
              f"planner: the sub-block cycle refused for {exc}")
    rep = null_test_plugin(prog, planner_input((2, 256, 0.3, 9)),
                           block_size=64, golden="native", compare_state=True,
                           compare_mem=True, engine="devexec", device=cuda)
    check(rep.passed, f"planner: the sub-block cycle on devexec {rep.summary()}")
    print(f"[planner] ring cycle at delay 3: refused by the vectorizer; on "
          f"devexec (K11) vs the native golden {rep.summary()}")
    return worst


def planner_phase(torch, cuda, rng, card):
    """The planner's paths on the card (`planner_cases`), then the chorus
    (dynamic ring reads; K3b's share of a traced second) and the dither
    (the fresh-render draw cache's miss and hit), 60 s of stereo each
    through PluginInstance.render, held to the native golden."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.lowering import specialize as SP
    from zorak_tpu_torch.parallel import BatchRenderer
    from zorak_tpu_torch.runtime.engine import PluginInstance

    t0 = time.perf_counter()
    worst = planner_cases(torch, cuda)
    print(f"[planner] the cases in {time.perf_counter() - t0:.1f} s, largest "
          f"audio difference from the golden {worst:.3e}")
    sec = MAIN_T / SR
    n1 = int(SR)
    out = {"planner_cases_max_abs_err": worst}

    # the chorus: twelve dynamic ring reads a sample at 3 voices
    voices, buf = PLANNER_CHORUS
    src = BP.modulated_delay_chorus(voices, buf)
    prog = compile_plugin_source(src)
    x = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
    inst = PluginInstance(prog, srate=SR)
    kern = inst.kernel
    reads = sum(n.kind == "dynringref" for n in kern._all_nodes(kern.sym))
    check(inst.engine == "torch-vector" and reads == 4 * voices,
          f"chorus: engine {inst.engine} ({inst.spec_error}), {reads} "
          f"dynamic reads")
    inst.render(x[:, :n1])                                # warm-up
    res = []
    gi_set_counts(dict.fromkeys(GI_COUNTERS, 0))
    t0 = time.perf_counter()
    ms = cuda_ms(lambda: res.append(inst.render(x)))
    wall = time.perf_counter() - t0
    launches = gi_counts()
    y = res[0].audio
    check(res[0].engine == "torch-vector" and y.shape == (2, MAIN_T)
          and bool(np.isfinite(y).all()), "chorus: output")
    seg = kern.segment_length(MAIN_T)
    segments = -(-MAIN_T // seg)
    check(launches == {k: n * segments
                       for k, n in PLANNER_K3B_PER_SEGMENT.items()},
          f"chorus: launches {launches} for {segments} segments of {seg}, "
          f"{PLANNER_K3B_PER_SEGMENT} a segment expected")
    check(res[0].details.get("dispatch") == "graph",
          f"chorus: the render ran as {res[0].details.get('dispatch')}")
    rep, gold_s = held_to_native_golden(prog, x, y, inst.shadow.state)
    check(rep.passed, f"chorus: vs the native golden {rep.summary()}")
    # a second render: every key captured by the first, each step replayed
    st0 = kern._k5.stats()
    again = []
    ms2 = cuda_ms(lambda: again.append(inst.render(x)))
    st1 = kern._k5.stats()
    print(f"[planner] chorus: the first 60 s render's steps {st0}; a second "
          f"render device_ms={ms2:.2f}, "
          f"{st1['replays'] - st0['replays']} of {segments} steps replayed "
          f"card='{card}'")
    print(f"[planner] modulated_delay_chorus({voices}, {buf}) 60 s stereo: "
          f"engine {res[0].engine}, {reads} dynamic ring reads a sample, "
          f"segment {seg}, K3b launched {launches['dyn_ring_read']} times "
          f"({launches['dyn_ring_read'] / segments:.0f} a segment); "
          f"device_ms={ms:.2f} wall_s={wall:.4f} "
          f"audio_s_per_s={sec / (ms / 1e3):.1f}; vs the native golden "
          f"{rep.summary()}, the golden {gold_s:.2f} s card='{card}'")
    # K3b's share of a traced second of the eager step (a K5 replay opens
    # no range): the kernels launched inside the emitter's K3b ranges
    # against every kernel's device time
    x_dev = torch.from_numpy(x[:, :n1]).to(cuda)
    kern._render_device_as("eager", x_dev)
    events = traced(lambda: kern._render_device_as("eager", x_dev))
    kernels = device_kernels(events)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    ranges, k3b_kernels = range_kernels(events, SP.K3B_RANGE)
    k3b_us = sum(k.time_range.elapsed_us() for k in k3b_kernels)
    share = k3b_us / busy_us if busy_us else None
    idle = None
    if kernels:
        span_us = (max(e.time_range.end for e in kernels)
                   - min(e.time_range.start for e in kernels))
        idle = 1.0 - busy_us / span_us
        check(ranges and k3b_us > 0, f"chorus: the trace's {len(ranges)} K3b "
              "ranges hold no device time")
    # K3b's least time in that second: each dynamic read's slot stream
    # read, its gathered values read and its output written, once, at the
    # card's memory rate (the chorus's cursor is an induction variable:
    # no cursor positions)
    k3b_bytes = 3 * reads * n1 * 8
    k3b_bound = k3b_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[planner] chorus, a traced 1 s (segments of "
          f"{kern.segment_length(n1)}): K3b bound {k3b_bound:.6f} ms (bytes: "
          f"{k3b_bytes}, {reads} reads' slots, gathers and outputs of {n1} "
          f"samples once)")
    print(f"[planner] chorus, a traced 1 s: {len(kernels)} device events, "
          f"busy {busy_us / 1e3:.3f} ms, idle share "
          + (f"{idle:.3f}" if idle is not None else "not measured")
          + f"; K3b (the kernels inside the emitter's {SP.K3B_RANGE} ranges: "
          f"cursor positions, slot arithmetic, last-writer choice, gathers; "
          f"{len(k3b_kernels)} kernels) {k3b_us / 1e3:.3f} ms, share "
          + (f"{share:.3f}" if share is not None else "not measured")
          + f" ({len(ranges)} ranges) card='{card}'")
    k5 = k5_held(torch, f"modulated_delay_chorus({voices}, {buf})", kern,
                 kernel_render(kern, torch.from_numpy(x).to(cuda)), MAIN_T,
                 card)
    print(f"[planner] chorus: K3b in the eager step {k3b_us / 1e3:.3f} ms "
          f"of {busy_us / 1e3:.3f} ms busy in the traced 1 s; the same "
          f"second replayed: {k5['graph_trace']['busy_ms']:.4f} ms busy a "
          f"segment card='{card}'")
    out.update(chorus_ms=ms, chorus_golden_s=gold_s, chorus_idle=idle,
               k3b_share=share, k3b_ms_traced_s=k3b_us / 1e3,
               k3b_bound_ms=k3b_bound,
               chorus_k5_ms_a_segment=k5["graph_ms_a_step"],
               chorus_k5_eager_ms_a_segment=k5["eager_ms_a_step"])
    # K3b at the chorus's shape: a middle segment's twelve reads, recorded
    # in an eager render of three segments, held bit for bit to the plain
    # version on the same inputs and timed
    t0 = time.perf_counter()
    xr = torch.from_numpy(x[None, :, :3 * seg]).to(cuda)
    yr = BatchRenderer(prog, SR, segment_len=seg).render_files(xr)
    rows = gi_held(torch, gi_recorded(torch, "chorus", src, seg, xr, yr,
                                      PLANNER_K3B_PER_SEGMENT, 1),
                   "chorus", True)
    r = rows["dyn_ring_read"]
    print(f"[planner] chorus: segment 1's K3b calls bit-identical to the "
          f"plain version on the same inputs "
          f"({time.perf_counter() - t0:.1f} s): " + gi_line(rows, card))
    out["k3b_entry"] = {
        "name": "dyn_ring_read", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/gated_index.cu",
        "replaces": "zorak_tpu/lowering/specialize.py:4432",
        "launches": launches["dyn_ring_read"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"] / r["calls"],
        "plain_ms": r["plain_ms"] / r["calls"],
        "bound_ms": r["bound_ms"] / r["calls"], "bound_by": "bytes",
        "library_ms": None, "per_segment": r["calls"], "segment": seg,
        "k3b_share": share, "chorus_ms": ms}

    # the dither: a fresh ungated render's draw matrix, the miss and the hit
    prog = compile_plugin_source(BP.tpdf_dither(PLANNER_DITHER_BITS))
    x = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
    inst = PluginInstance(prog, srate=SR)
    kern = inst.kernel
    check(inst.engine == "torch-vector" and kern.n_rand == 4
          and not kern.rand_gated, f"dither: engine {inst.engine} "
          f"({inst.spec_error}), {kern.n_rand} draws a sample")
    streams, mt_s = kern._rand_streams, []

    def timed_streams(T, reset):
        t = time.perf_counter()
        draws = streams(T, reset)
        mt_s.append(time.perf_counter() - t)
        return draws

    kern._rand_streams = timed_streams
    timing = {}
    try:
        for which in ("miss", "hit"):
            res = []
            t0 = time.perf_counter()
            ms = cuda_ms(lambda: res.append(inst.render(x)))
            timing[which] = (ms, time.perf_counter() - t0, res[0].audio,
                             kern._rng_state)
            if which == "miss":
                cached, state = kern._rand_cache[MAIN_T]
                kept = cached.clone()
    finally:
        del kern._rand_streams
    (ms_m, wall_m, y_m, rng_m), (ms_h, wall_h, y_h, rng_h) = (
        timing["miss"], timing["hit"])
    check(len(mt_s) == 1, f"dither: the host generated {len(mt_s)} times")
    check(cached.device.type == kern.device.type
          and cached.dtype == torch.float64
          and tuple(cached.shape) == (MAIN_T, 4), "dither: the cached matrix")
    check(kern._rand_cache[MAIN_T][0] is cached and torch.equal(cached, kept),
          "dither: a render wrote into the cached matrix")
    check(torch.equal(torch.from_numpy(y_m), torch.from_numpy(y_h)),
          "dither: the hit's audio differs from the miss's")
    check(np.array_equal(rng_m[0], rng_h[0]) and rng_m[1] == rng_h[1]
          and np.array_equal(state[0], rng_h[0]),
          "dither: the generator after the hit differs from the miss's")
    rep, gold_s = held_to_native_golden(prog, x, y_h, inst.shadow.state)
    check(rep.passed, f"dither: vs the native golden {rep.summary()}")
    mb = cached.numel() * 8 / 1e6
    print(f"[planner] tpdf_dither({PLANNER_DITHER_BITS}) 60 s stereo, 4 "
          f"draws a sample: the first fresh render (the cache's miss) "
          f"device_ms={ms_m:.2f} wall_s={wall_m:.4f}, of it the host's "
          f"MT19937 {mt_s[0]:.4f} s and a {mb:.1f} MB matrix put on the "
          f"card; the second (the hit) device_ms={ms_h:.2f} "
          f"wall_s={wall_h:.4f}; the hit's audio torch.equal to the miss's, "
          f"the generator equal, the matrix unchanged; vs the native golden "
          f"{rep.summary()}, the golden {gold_s:.2f} s card='{card}'")
    check(kern.dispatch == "graph", f"dither: ran as {kern.dispatch}")
    k5 = k5_held(torch, f"tpdf_dither({PLANNER_DITHER_BITS})", kern,
                 kernel_render(kern, torch.from_numpy(x).to(cuda)), MAIN_T,
                 card)
    out.update(dither_k5_ms_a_segment=k5["graph_ms_a_step"],
               dither_k5_eager_ms_a_segment=k5["eager_ms_a_step"])
    out.update(dither_miss_ms=ms_m, dither_hit_ms=ms_h,
               dither_miss_wall_s=wall_m, dither_hit_wall_s=wall_h,
               dither_mt19937_s=mt_s[0], dither_golden_s=gold_s)
    return out


DEVEXEC_GRAINS, DEVEXEC_RING = 16, 131072   # the Texture stand-in
DEVEXEC_NOTE_EVERY = 24000      # a note-on every 0.5 s
DEVEXEC_SHORT_T = 1100          # two blocks and a remainder of 76
DEVEXEC_FILES = (1, 8, 64, 256)
DEVEXEC_LIBM_TOL = 1e-8         # where the body calls the device's libm
DEVEXEC_FILES_T = 480000        # 10 s a file in the batches' timing
DEVEXEC_PROBE_T = 480000        # the section probe: 1 file x 10 s
DEVEXEC_LINK_REPS = {"add": 1 << 24, "sin": 1 << 22, "shared": 1 << 22,
                     "l1": 1 << 22, "l2": 1 << 22, "heap": 1 << 22}


# cells 4,090 to 4,100 read and written, and memcpy, memset and the FFT
# family on runs inside K11's on-chip page, past it and across cell 4,096
# (tests/test_torch_devexec.py's "page_edge")
DEVEXEC_PAGE_EDGE_SRC = (
    "options:maxmem=16384\n@init\n"
    "e = 4090; A = 3000; B = 8000; C = 4080; D = 4088;\nn = 0;\n"
    "@sample\nk = 0;\n"
    "loop(11, e[k] = e[k] * 0.5 + spl0 * (k + 1) * 0.1; k += 1;);\n"
    "acc = e[2] + e[7] + e[k - 1];\nn += 1;\nm = n % 128;\n"
    "m == 10 ? ( memcpy(1000, 4088, 16); memset(6000, acc, 16);\n"
    "            memcpy(4070, 6000, 40); memcpy(5200, 6000, 16); );\n"
    "m == 20 ? ( memcpy(5000, 4085, 24); memset(4091, spl0, 8);\n"
    "            memcpy(2000, 1000, 16); memset(5100, acc * 2, 8);\n"
    "            memset(2100, acc, 8); );\n"
    "m == 30 ? ( i = 0; loop(32, A[i] = e[i % 11] * 0.01 + i * 0.001;\n"
    "            B[i] = A[i] * 2; C[i] = A[i] * 3; i += 1;);\n"
    "            fft(A, 16); ifft(A, 16); fft(B, 16); ifft(B, 16);\n"
    "            fft(C, 16); ifft(C, 16); );\n"
    "m == 40 ? ( convolve_c(D, A, 8); fft_real(C, 32); );\n"
    "spl0 = spl0 * 0.5 + acc * 0.01;\n")


# gmem and a lone instance's bus on K11 (tests/test_torch_devexec_comm.py's
# "gmem_bulk" and "lone_bus"): gmem_get and gmem_put across cell 4,096,
# inside the page and past it, fill, zero and both overlaps of copy, counts
# cut at the segment's end, dynamic and static gmem[] with -1 and NaN, the
# inert bus with its out-params, a voice count the vectorizers reject
DEVEXEC_GMEM_CASE = "gmem and a lone bus"
DEVEXEC_GMEM_SRC = (
    "options:maxmem=65536\n@init\nk = 0;\n"
    "loop(64, gmem[1000 + k] = k * 0.5 + 1; k += 1;);\n"
    "me = instance_id(); comm_join(\"d\"); msg_advertise(\"c\", 1);\n"
    "@block\ngmem_get(4070, 1000, 40);\ngmem_get(100, 1010, 8);\n"
    "gmem_get(5000, 1000, 16);\n"
    "4075[0] += bc; 4100[0] -= bc * 0.5; 5003[0] *= 1.5; 101[0] += 0.25;\n"
    "gmem_put(2000, 4080, 30);\ngmem_put(2100, 5000, 16);\n"
    "gmem_fill(3000, bc * 0.1, 10);\ngmem_zero(3004, 3);\n"
    "gmem_copy(3100, 3000, 10);\ngmem_copy(2005, 2000, 20);\n"
    "gmem_copy(2200, 2203, 6);\n"
    "r = gmem_put(1048570, 4090, 20) + gmem_get(4085, 1048572, 8);\n"
    "gmem[-1] += 1; gmem[0/0] += 0.5;\n"
    "me2 = instance_id(); sv = 11; tg = 12; pa = 13;\n"
    "r3 = msg_recv(\"c\", sv, tg, pa, 7000[0], 7001[0], 7002[bc % 3]);\n"
    "r4 = msg_send(\"c\", 1, 2, 3, 4, 5) + msg_avail(\"c\")"
    " + msg_peer_count(\"c\", 1) + comm_join(\"d\");\n"
    "while (msg_recv(\"c\", sv, tg, pa, pb, pc, pd)) ( cnt += 1; );\n"
    "gmem[me2 + 10] = bc + r3 + r4;\nbc += 1;\n"
    "@sample\nn = abs(spl0) > 0.3 ? 3 : 1; i = 0;\n"
    "loop(n, 200[i] = 200[i] * 0.5 + spl0; i += 1;);\n"
    "j = 0; loop(n, acc2 += gmem[abs(spl0) * 8 + j] * 0.01; j += 1;);\n"
    "acc = acc * 0.99 + 4090[0] * 0.001 + gmem[2010] * 0.001"
    " + gmem[3102] * 0.01 + 4100[0] * 0.0001 + (sv + tg + pa) * 1e-6;\n"
    "spl0 = spl0 * 0.5 + acc + acc2 * 0.001 + r * 0.0001 + 200[1] * 0.1;\n")
# the gmem stand-in at full width (builtin_plugins.scene_voice_panner)
DEVEXEC_PANNER = (8, 256)


def devexec_cases():
    """The cases of tests/test_devexec.py that need no host service, and
    gmem and a lone instance's bus: name -> (source, input, renders)."""
    def noise(ch, n, seed=5):
        return (np.random.RandomState(seed).randn(ch, n) * 0.6).astype(
            np.float32)

    return {
        "voice loop": (
            "@init\nbuf = 1000;\nn_active = 0;\n@block\nctr += 1;\n"
            "@sample\nx = abs(spl0);\n"
            "x > 0.5 ? n_active = min(n_active + 2, 8) :"
            " (n_active > 0 ? n_active -= 1);\n"
            "acc = 0; i = 0;\nloop(n_active,\n"
            "  acc += buf[i] * 0.1 + x * 0.01;\n  buf[i] = x;\n  i += 1;\n);\n"
            "spl0 = spl0 * 0.7 + acc * 0.05;\nspl1 = spl1 * 0.7;\n",
            noise(2, 3000), 1),
        "rand() across resumed renders": (
            "@init\nnz = 0;\n@block\nwant = 2 + (bc % 3);\nbc += 1;\ni = 0;\n"
            "loop(want, noise[i] = rand(2) - 1; i += 1; );\n"
            "@sample\np = abs(spl0) > 0.4 ? rand() * 0.1 : 0;\n"
            "spl0 = spl0 * 0.8 + p + noise[0] * 0.01;\n", noise(1, 3000), 3),
        "pending retrigger": (
            "slider1:10<0,100,1>Amt\n@init\nq = 0;\n@slider\n"
            "g = slider1 / 100;\n@block\nbc += 1;\n"
            "bc == 3 ? ( slider1 = 50; sliderchange(slider1); );\n"
            "@sample\nspl0 *= g;\n", noise(1, 4000), 1),
        "FFT at a traced base": (
            "@init\nbufA = 1024; bufB = 2048;\nacc = 0;\n@sample\n"
            "sel = spl0 > 0 ? bufA : bufB;\nsel[w] = spl0;\nw += 1;\n"
            "w >= 64 ? (\n  w = 0;\n  fft_real(sel, 64);\n"
            "  fft_permute(sel, 16);\n  acc = sel[0] * 0.01 + sel[2] * 0.005;\n"
            "  j = 0; loop(64, sel[j] = 0; j += 1;);\n);\n"
            "spl0 = spl0 * 0.5 + acc * 0.001;\n", noise(1, 2000), 1),
        "heap that grows": (
            "@init\nbuf = 100;\nctr = 0;\n@sample\n"
            "n = abs(spl0) > 0.2 ? 3 : 1;\n"
            "loop(n, buf[ctr] = spl0; ctr += 1; );\n"
            "spl0 = spl0 * 0.5 + buf[ctr > 3000 ? ctr - 3000 : 0] * 0.1;\n",
            noise(1, 6000), 1),
        "the page edge": (DEVEXEC_PAGE_EDGE_SRC, noise(1, 3000), 1),
        # 2,100 var slots: the row and the page in dynamic shared memory
        "a wide var row": ("@sample\nv0 = spl0 * 0.5;\n" + "".join(
            f"v{k} = v{k - 1} * 0.999 + {k} * 0.000001;\n"
            for k in range(1, 2100)) + "spl0 = v2099;\n", noise(1, 2000), 1),
        DEVEXEC_GMEM_CASE: (DEVEXEC_GMEM_SRC, noise(1, 3000), 2),
    }


# the SASS instructions counted in K11's kernel
SASS_OPS = ("LDG", "STG", "LDS", "STS", "LDL", "STL", "CALL")


def sass_counts(text: str, function: str):
    """One function of cuobjdump -sass's listing: (the opcode counts of
    SASS_OPS in its body, the same in the subroutines it calls, the call
    targets).  The subroutines (the libm's slow paths, which nvcc does not
    inline) lie after the body: from the lowest call target on."""
    import re

    ins, inside = [], False
    for line in text.splitlines():
        if "Function : " in line:
            inside = function in line.split("Function : ", 1)[1]
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9]*)([^;]*)", line)
        if inside and m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    targets = sorted({int(t, 16) for _a, op, rest in ins if op == "CALL"
                      for t in re.findall(r"0x([0-9a-f]+)", rest)})
    edge = targets[0] if targets else float("inf")
    body, subs = dict.fromkeys(SASS_OPS, 0), dict.fromkeys(SASS_OPS, 0)
    for a, op, _rest in ins:
        if op in body:
            (body if a < edge else subs)[op] += 1
    return body, subs, [hex(t) for t in targets]


def ptxas_functions(log: str):
    """The functions ptxas compiled on their own (-Xptxas -v's "Function
    properties for" lines): the kernels and what they call."""
    return [line.split("Function properties for", 1)[1].strip()
            for line in log.splitlines() if "Function properties for" in line]


def k11_sass(programs, logs):
    """K11's SASS (cuobjdump -sass on each built library): the memory
    instructions and calls of zx_kernel's body and of the subroutines it
    calls.  Checks that no K11 function was compiled apart from the
    kernels (every section, user function and helper is inlined), so
    that every call goes to the libm's own (`__internal_*`), and that the
    stand-in's body touches no local memory: the only local memory is the
    libm's (the trig reduction's array for huge arguments, also in the
    latency probe's kernel, whose one sin brings it).  The stand-in's
    listing goes to chiprun_out/."""
    from zorak_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    out = {}
    for label, prog in programs.items():
        lib = _build.generated_paths(prog.source)[1]
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        if label == "stand-in":
            Path("chiprun_out").mkdir(exist_ok=True)
            Path("chiprun_out/devexec_sass.txt").write_text(text)
        body, subs, targets = sass_counts(text, "zx_kernel")
        funcs = ptxas_functions(logs[prog.source])
        apart = [f for f in funcs if "zx_kernel" not in f
                 and "zx_latency_kernel" not in f
                 and not f.startswith("__internal")]
        out[label] = {"body": body, "subroutines": subs, "targets": targets,
                      "functions": funcs}
        print(f"[devexec] K11 SASS, {label}: zx_kernel's body "
              + ", ".join(f"{k} {v}" for k, v in body.items())
              + f"; its {len(targets)} subroutine(s) (the libm's) "
              + ", ".join(f"{k} {v}" for k, v in subs.items() if v)
              + f"; compiled apart: {funcs}")
        check(not apart, f"K11 {label}: {apart} compiled apart, not inlined")
        # the main path's kernel keeps its state out of local memory (a
        # case's register spills, as the wide var row's, are printed)
        check(label != "stand-in" or (body["LDL"] == 0 and body["STL"] == 0),
              f"K11 {label}: local memory in zx_kernel's body ({body})")
    return out


def devexec_section_probe(torch, cuda, rng, DX, kern, notes, card):
    """K11's section probe: one file x DEVEXEC_PROBE_T samples of the
    stand-in with note-ons through the ZX_PROBE build, clock64() around
    each section call and the sample loop's I/O; the shares of the
    render's cycles, and its cycles and time a sample."""
    T = DEVEXEC_PROBE_T
    x = torch.from_numpy((rng.randn(1, 2, T) * 0.25).astype(np.float32)).to(cuda)
    mev, mn = kern._midi_planes([n for n in notes if n[0] < T], T)
    planes = (torch.from_numpy(mev).to(cuda), torch.from_numpy(mn).to(cuda))
    bv, bm = kern.initial_carry()
    bv, bm = bv[None].contiguous(), bm[None].contiguous()
    pool = kern._stage_rand_pool(None)
    bv[:, kern._rpos] = 0.0
    got = []
    ms = cuda_ms(lambda: got.append(DX.section_probe(
        kern.program, x, bv, bm, pool, planes)))
    cyc = got[0][0].tolist()
    total = cyc[DX.PROBE_NAMES.index("render")]
    shares = {nm: c / total for nm, c in zip(DX.PROBE_NAMES, cyc)
              if nm != "render"}
    shares["other"] = 1.0 - sum(shares.values())
    ghz = total / (ms * 1e6)
    print(f"[devexec] section probe, 1 file x {T / SR:.0f} s (clock64() "
          f"around each call): " + ", ".join(
              f"{nm} {v:.4f}" for nm, v in shares.items())
          + f" of {total} cycles ({total / T:.1f} a sample; the probe build "
          f"{ms:.2f} ms, {ms * 1e6 / T:.1f} ns a sample, {ghz:.3f} GHz); "
          f"high water {float(bv[0, kern._hw]):.0f} card='{card}'")
    return {"shares": shares, "cycles": cyc, "ms": ms,
            "cycles_per_sample": total / T, "ns_per_sample": ms * 1e6 / T}


def devexec_links(torch, cuda, DX, program, card):
    """The latency probe's links, ns each: a dependent f64 add, an f64 sin
    with its add, and dependent loads from shared memory, L1 and L2."""
    out = torch.zeros(1, dtype=torch.float64, device=cuda)
    chase = torch.from_numpy(DX.chase_table()).to(cuda)
    ns = {}
    for link in DX.LINKS:
        reps = DEVEXEC_LINK_REPS[link]
        DX.latency_probe(program, out, 1 << 10, link, chase)   # warm
        ns[link] = cuda_ms(lambda: DX.latency_probe(
            program, out, reps, link, chase)) * 1e6 / reps
    print("[devexec] latency probe, ns a dependent link on one thread: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ns.items())
          + f" card='{card}'")
    return ns


def devexec_phase(torch, cuda, rng, card):
    """The sequential device executor: K11 built (nvcc seconds, registers
    and spills), held to its plain version on the card (the stand-in, 1 and
    8 files, 1,100 samples) and the test cases to the native golden; then
    grain_texture(16, 131072) through PluginInstance.render on 60 s of
    stereo (engine torch-devexec, the heap's ladder, the draws, held to the
    native golden), the gmem stand-in scene_voice_panner(8, 256) the same
    way (gmem held too), 8 files against their solo renders, audio-s per s
    at 1 to 256 files beside the golden's, and K11's entry for the
    `kernels` line."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import device_exec as DX
    from zorak_tpu_torch.lowering.devexec import DeviceExecKernel
    from zorak_tpu_torch.runtime.engine import PluginInstance
    from zorak_tpu_torch.verify import AUDIO_EPS, SCALAR_EPS
    from zorak_tpu_torch.verify.nulltest import make_initialized_shadow

    sec = MAIN_T / SR
    prog = compile_plugin_source(BP.grain_texture(DEVEXEC_GRAINS,
                                                  DEVEXEC_RING))

    def kernel_of(p, nch):
        return DeviceExecKernel(p, make_initialized_shadow(p, SR).state, nch)

    # 1. build: the stand-ins' K11 and the cases', one nvcc each, together
    cases = {name: (compile_plugin_source(src), x, renders)
             for name, (src, x, renders) in devexec_cases().items()}
    stand = kernel_of(prog, 2)
    pprog = compile_plugin_source(BP.scene_voice_panner(*DEVEXEC_PANNER))
    panner = kernel_of(pprog, 2)
    case_kernels = {name: kernel_of(p, x.shape[0])
                    for name, (p, x, _r) in cases.items()}
    t0 = time.perf_counter()
    logs = DX.build([stand.program, panner.program]
                    + [k.program for k in case_kernels.values()],
                    probes=[stand.program])
    print(f"[devexec] K11 builds: {len(logs)} generated sources in "
          f"{time.perf_counter() - t0:.2f} s of nvcc, all together "
          f"(the stand-in's source {len(stand.program.source)} characters)")
    for line in logs[stand.program.source].splitlines():
        if any(w in line for w in ("registers", "spill", "entry function",
                                   "Function properties")):
            print(f"[devexec] K11 build: {line.strip()}")
    occ = DX.occupancy(stand.program)
    print(f"[devexec] K11 on the card: {occ['registers']} registers a "
          f"thread, {occ['smem_bytes']} bytes of shared memory a block "
          f"({'dynamic' if stand.program.dynamic_smem else 'static'}), "
          f"{occ['blocks_per_sm']} blocks (files) an SM at once")
    check(occ["blocks_per_sm"] >= 1, "K11: no block fits an SM")
    sass = k11_sass({"stand-in": stand.program,
                     "gmem stand-in": panner.program,
                     **{name: k.program for name, k in case_kernels.items()}},
                    logs)

    # 2. K11 against its plain version on the card: the stand-in at the
    # heap's top rung, 1 and 8 files of 1,100 samples with note-ons
    stand.grow_to(1 << 19)
    T = DEVEXEC_SHORT_T
    x8 = torch.from_numpy((rng.randn(8, 2, T) * 0.25).astype(np.float32))
    mev, mn = stand._midi_planes([(5, 0x90, 60, 100), (700, 0x90, 64, 80)], T)
    planes = (torch.from_numpy(mev), torch.from_numpy(mn))
    bv0, bm0 = stand.initial_carry()
    pool = stand._stage_rand_pool(None)
    names = {slot: key for key, slot in stand.sample.slots.items()}
    errs, plain_ms = [], None
    for nf in (1, 8):
        bv = bv0.expand(nf, -1).contiguous()
        bv[:, stand._rpos] = 0.0
        bm = bm0.expand(nf, -1).contiguous()
        bv_c, bm_c = bv.to("cpu", copy=True), bm.to("cpu", copy=True)
        y, _mo = DX.device_exec(stand.program, x8[:nf].to(cuda), bv, bm, pool,
                                tuple(p.to(cuda) for p in planes))
        t_p = time.perf_counter()
        y_c, _mo_c = DX.device_exec(stand.program, x8[:nf], bv_c, bm_c,
                                    pool.cpu(), planes)
        if nf == 1:
            plain_ms = (time.perf_counter() - t_p) * 1e3
        y, bv, bm = y.cpu(), bv.cpu(), bm.cpu()
        d_y = (y.double() - y_c.double()).abs()
        ulp = torch.clamp(y_c.double().abs() * 2.0 ** -23, min=DEVEXEC_LIBM_TOL)
        d_v, d_m = (bv - bv_c).abs(), (bm - bm_c).abs()
        slots = sorted({names[int(i)] for i in torch.nonzero(d_v.amax(0))[:, 0]},
                       key=repr)
        cells = torch.nonzero(d_m.amax(0))[:, 0]
        err = max(float(d_y.max()), float(d_v.max()), float(d_m.max()))
        errs.append(err)
        print(f"[devexec] K11 vs its plain version, {nf} file(s) x {T} "
              f"samples, note-ons: audio {int((d_y > 0).sum())} of "
              f"{d_y.numel()} samples differ (max {float(d_y.max()):.3e}), "
              f"vars {len(slots)} slot(s) differ {slots[:12]}, heap "
              f"{len(cells)} cell(s) differ"
              + (f" in [{int(cells.min())}, {int(cells.max())}]"
                 if len(cells) else "")
              + f" (max {max(float(d_v.max()), float(d_m.max())):.3e}); "
              f"draws {bv_c[:, stand._rpos].tolist()[:8]}, high water "
              f"{float(bv_c[:, stand._hw].max()):.0f}")
        check(bool((d_y <= ulp).all()) and float(d_v.max()) <= DEVEXEC_LIBM_TOL
              and float(d_m.max()) <= DEVEXEC_LIBM_TOL,
              f"K11 {nf} file(s): {err:.3e} from the plain version")
        check(float(bv_c[:, stand._rpos].min()) > 0
              and float(bv_c[:, stand._hw].max()) < stand.mem_size,
              f"K11 {nf} file(s): no draw, or the heap overflowed")
    print(f"[devexec] the plain version of 1 file x {T} samples: "
          f"{plain_ms:.1f} ms on the host (the Python golden a file)")

    # the gmem and lone-bus case: K11 on 3 files, each file's gmem window in
    # its heap row, bit for bit to its plain version (the var row but the
    # high-water slot: the kernel marks dynamic writes only, as the
    # reference does, the plain version static ones too, all inside the
    # heap)
    gk = case_kernels[DEVEXEC_GMEM_CASE]
    xg = torch.from_numpy((rng.randn(3, 1, T) * 0.4).astype(np.float32))
    bvg, bmg = gk.initial_carry()
    bvg, bmg = bvg.expand(3, -1).contiguous(), bmg.expand(3, -1).contiguous()
    bvg_c, bmg_c = bvg.to("cpu", copy=True), bmg.to("cpu", copy=True)
    yg, _ = DX.device_exec(gk.program, xg.to(cuda), bvg, bmg)
    yg_c, _ = DX.device_exec(gk.program, xg, bvg_c, bmg_c)
    rest = [i for i in range(gk.sample.n_vars) if i != gk._hw]
    yg, bvg, bmg = yg.cpu(), bvg.cpu(), bmg.cpu()
    gmem_case_err = max(float((yg - yg_c).abs().max()),
                        float((bvg[:, rest] - bvg_c[:, rest]).abs().max()),
                        float((bmg - bmg_c).abs().max()))
    g0, G = gk.sample.gmem_base, gk.sample.gmem_cells
    print(f"[devexec] K11 vs its plain version, {DEVEXEC_GMEM_CASE}, 3 files "
          f"x {T} samples, gmem windows of {G} cells at {g0} in rows of "
          f"{gk.sample.total_mem}: audio, vars (the high water aside: "
          f"{bvg[:, gk._hw].tolist()} and {bvg_c[:, gk._hw].tolist()}) and "
          f"rows bit for bit: {gmem_case_err == 0.0} (max {gmem_case_err:.3e}"
          f"); {int((bmg[:, g0:g0 + G] != gk.initial_carry()[1][g0:g0 + G].cpu()).sum())}"
          f" window cells written")
    check(torch.equal(yg, yg_c) and torch.equal(bvg[:, rest], bvg_c[:, rest])
          and torch.equal(bmg, bmg_c)
          and float(bvg[:, gk._hw].max()) < gk.mem_size,
          f"K11 {DEVEXEC_GMEM_CASE}: {gmem_case_err:.3e} from the plain "
          "version")
    errs.append(gmem_case_err)

    # the cases of tests/test_devexec.py against the native golden
    for name, (p, x, renders) in cases.items():
        kern = case_kernels[name]
        owner_state = kern.snap
        cut = max(512, (x.shape[1] // renders // 512) * 512)
        parts, carry, pos = [], None, 0
        while pos < x.shape[1]:
            stop = x.shape[1] if len(parts) == renders - 1 \
                else min(pos + cut, x.shape[1])
            yp, carry = kern.render(x[:, pos:stop], carry=carry)
            parts.append(yp)
            pos = stop
        kern.writeback(carry, owner_state)
        y = np.concatenate(parts, axis=1)
        rep, _s, g_err = held_to_native_golden(p, x, y, owner_state,
                                               gmem=True)
        check(rep.passed and rep.max_abs_delta <= 1e-6
              and g_err <= SCALAR_EPS, f"devexec {name}: {rep.summary()}, "
              f"gmem {g_err:.3e}")
        print(f"[devexec] {name} ({renders} render(s), heap {kern.mem_size}"
              f", climbs {kern.heap_climbs}, gmem window "
              f"{kern.sample.gmem_cells} cells, {kern.program.smem_bytes} "
              f"bytes of {'dynamic' if kern.program.dynamic_smem else 'static'}"
              f" shared memory) on the card vs the native golden: "
              f"{rep.summary()}; gmem max |delta| {g_err:.3e}")

    # 3. the slice at full width: PluginInstance.render of the stand-in
    x = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
    notes = [(o, 0x90, 48 + (o // DEVEXEC_NOTE_EVERY) % 24, 100)
             for o in range(100, MAIN_T, DEVEXEC_NOTE_EVERY)]
    inst = PluginInstance(prog, srate=SR)
    kern = inst.kernel
    check(inst.engine == "torch-devexec" and kern.device.type == "cuda",
          f"devexec: engine {inst.engine} ({inst.spec_error})")
    # each K11 launch of the render timed by CUDA events around it (the
    # last one is the render the ladder kept)
    real, launch_ev = DX.device_exec, []

    def timed(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = real(*a, **k)
        ev[1].record()
        launch_ev.append(ev)
        return got

    DX.LAUNCHES = 0
    out = []
    DX.device_exec = timed
    t0 = time.perf_counter()
    try:
        ms = cuda_ms(lambda: out.append(inst.render(x, midi=notes)))
    finally:
        DX.device_exec = real
    wall = time.perf_counter() - t0
    launches = DX.LAUNCHES
    launch_ms = [a.elapsed_time(b) for a, b in launch_ev]
    k_ms = launch_ms[-1]
    res = out[0]
    y = res.audio
    check(res.engine == "torch-devexec", f"devexec: rendered by {res.engine}")
    check(y.shape == (2, MAIN_T) and bool(np.isfinite(y).all()),
          "devexec: output not finite or of the wrong shape")
    check(launches == 1 + len(kern.heap_climbs) and kern.heap_climbs
          and kern.mem_size == 1 << 19,
          f"devexec: {launches} launches, climbs {kern.heap_climbs}")
    draws = kern.last_draws
    check(0 < draws < kern._rand_cap // 2,
          f"devexec: {draws} draws of a pool of {kern._rand_cap}")
    print(f"[devexec] grain_texture({DEVEXEC_GRAINS}, {DEVEXEC_RING}) 60 s "
          f"stereo, {len(notes)} note-ons: engine={res.engine} "
          f"device_ms={ms:.2f} wall_s={wall:.4f} "
          f"audio_s_per_s={sec / (ms / 1e3):.3f} K11 launches {launches} (1 "
          f"+ {len(kern.heap_climbs)} ladder replays; "
          f"{', '.join(f'{v:.2f}' for v in launch_ms)} ms); heap 4096 -> "
          f"{' -> '.join(str(c) for c in kern.heap_climbs)} cells; draws "
          f"{draws} of a pool of {kern._rand_cap} card='{card}'")
    rep, gold_s, nact = held_to_native_golden(
        prog, x, y, inst.shadow.state, midi=notes, trace="nact")
    print(f"[devexec] whole 60 s, PluginInstance.render on the card vs the "
          f"native golden (audio {AUDIO_EPS}, vars and heap {SCALAR_EPS}): "
          f"{rep.summary()}; the golden alone {gold_s:.2f} s on one host "
          f"core ({sec / gold_s:.2f} audio-s per s)")
    check(rep.passed, "devexec: the 60 s render disagrees with the native "
          "golden")
    B = stand.B
    lens = np.minimum(B, MAIN_T - B * np.arange(len(nact)))
    mean_nact = float(np.dot(nact, lens) / MAIN_T)

    # 3b. the gmem stand-in at full width: scene_voice_panner through
    # PluginInstance.render on 60 s of stereo, its gmem window, inert bus
    # and level-driven voice loop on K11, held to the native golden with
    # the state's gmem
    xp = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
    pinst = PluginInstance(pprog, srate=SR)
    check(pinst.engine == "torch-devexec"
          and pinst.kernel.sample.gmem_cells == 1 << 20,
          f"devexec gmem stand-in: engine {pinst.engine} ({pinst.spec_error})")
    launch_ev.clear()
    outp = []
    climbs0 = len(pinst.kernel.heap_climbs)     # the build's climbs
    DX.LAUNCHES = 0
    DX.device_exec = timed
    t0 = time.perf_counter()
    try:
        p_ms = cuda_ms(lambda: outp.append(pinst.render(xp)))
    finally:
        DX.device_exec = real
    p_wall = time.perf_counter() - t0
    p_launches = DX.LAUNCHES
    p_launch_ms = [a.elapsed_time(b) for a, b in launch_ev]
    pres = outp[0]
    check(pres.engine == "torch-devexec" and p_launches >= 1
          and p_launches == 1 + len(pinst.kernel.heap_climbs) - climbs0
          and pres.audio.shape == (2, MAIN_T)
          and bool(np.isfinite(pres.audio).all()),
          f"devexec gmem stand-in: {pres.engine}, {p_launches} launches")
    prep, p_gold_s, p_gerr = held_to_native_golden(
        pprog, xp, pres.audio, pinst.shadow.state, gmem=True)
    print(f"[devexec] scene_voice_panner{DEVEXEC_PANNER} 60 s stereo: "
          f"engine={pres.engine} device_ms={p_ms:.2f} wall_s={p_wall:.4f} "
          f"K11 launches {p_launches} ({', '.join(f'{v:.2f}' for v in p_launch_ms)}"
          f" ms; heap {pinst.kernel.mem_size}, window "
          f"{pinst.kernel.sample.gmem_cells} cells); vs the native golden "
          f"(audio {AUDIO_EPS}, vars, heap and gmem {SCALAR_EPS}): "
          f"{prep.summary()}, gmem max |delta| {p_gerr:.3e}; the golden alone "
          f"{p_gold_s:.2f} s on one host core ({sec / p_gold_s:.2f} audio-s "
          f"per s) card='{card}'")
    check(prep.passed and p_gerr <= SCALAR_EPS,
          "devexec gmem stand-in: the 60 s render disagrees with the native "
          "golden")

    # 4. files: each of 8 files x 2 s torch.equal to its solo render, then
    # the throughput at 1 to 256 files (each kernel already at its rung)
    n2 = 2 * int(SR)
    xf = torch.from_numpy((rng.randn(8, 2, n2) * 0.25).astype(np.float32))
    many = kernel_of(prog, 2)
    y8, _c = many.render_files(xf)
    for f in range(8):
        solo, _c = many.render_device(xf[f])
        check(torch.equal(y8[f], solo),
              f"devexec batch: file {f} differs from its solo render")
    print(f"[devexec] 8 files x 2 s through render_files (one K11 launch): "
          f"every file torch.equal to its solo render; climbs "
          f"{many.heap_climbs}")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SEED)
    T_files = DEVEXEC_FILES_T

    def files_of(n, t):
        return torch.randn((n, 2, t), generator=gen, device=cuda) * 0.25

    rates = {1: sec / (k_ms / 1e3)}     # one file: the main render's launch
    for n in DEVEXEC_FILES[1:]:
        xn = files_of(n, T_files)
        f_ms = cuda_ms(lambda: many.render_files(xn))
        rates[n] = n * T_files / SR / (f_ms / 1e3)
        print(f"[devexec] {n} file(s) x {T_files / SR:.0f} s: {f_ms:.1f} ms, "
              f"{rates[n]:.3f} audio-s per s (the golden {sec / gold_s:.2f} on "
              f"one host core); heap rows {n * many.sample.total_mem * 8 / 1e9:.3f}"
              f" GB card='{card}'")
        del xn
    over = [n for n in DEVEXEC_FILES if rates[n] >= sec / gold_s]
    print(f"[devexec] the card overtakes the golden on one host core at "
          + (f"{over[0]} files" if over else
             f"no file count up to {DEVEXEC_FILES[-1]}"))

    # 5. K11's entry: the main render's kept launch, its bounds
    sections = devexec_section_probe(torch, cuda, rng, DX, kern, notes, card)
    links = devexec_links(torch, cuda, DX, kern.program, card)
    ns_op = links["add"]
    ops = DX.sample_chain_ops(kern.program, {"nact": mean_nact})
    chain_ms = MAIN_T * ops * ns_op / 1e6
    # the same chain with its loads and its sin priced at the probe's
    # latencies: every heap load from shared memory, L1 or L2, or at what
    # K11's accessor takes beyond the address's two adds
    loads = {k: links[k] for k in ("shared", "l1", "l2")}
    loads["heap"] = links["heap"] - 2 * ns_op
    priced = {where: MAIN_T * DX.sample_chain_ops(
        kern.program, {"nact": mean_nact},
        {"op": ns_op, "libm": links["sin"], "load": ns}) / 1e6
        for where, ns in loads.items()}
    print(f"[devexec] K11's chain priced (an add {ns_op:.3f} ns, sin "
          f"{links['sin']:.3f} ns, every heap load from shared memory, L1, "
          f"L2 or through K11's accessor): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in priced.items())
          + f" for 1 file x 60 s card='{card}'")
    g, r = DEVEXEC_GRAINS, DEVEXEC_RING
    cells = 2 * min(MAIN_T, r) + 20 * g + 8      # rings, records, tables
    nbytes = 2 * (2 * MAIN_T * 4) + 2 * cells * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms = max(bytes_ms, chain_ms)
    by = "operations" if chain_ms >= bytes_ms else "bytes"
    print(f"[devexec] K11, the main render's kept launch (1 file x 60 s): "
          f"{k_ms:.2f} ms; chain bound {chain_ms:.2f} ms ({MAIN_T} samples x "
          f"{ops:.2f} dependent f64 operations a step, counted on the "
          f"@sample syntax tree with the run's mean of {mean_nact:.3f} active "
          f"grains, x {ns_op:.3f} ns a dependent add by the probe), bytes "
          f"bound {bytes_ms:.4f} ms ({nbytes} bytes: audio in and out, "
          f"{cells} heap cells read and written once) card='{card}'")
    return {"name": "device_exec", "route": "cuda",
            "source": "zorak_tpu_torch/kernels/device_exec.py",
            "replaces": "zorak_tpu/lowering/devexec.py:491",
            "launches": launches, "max_abs_err": max(errs), "ms": k_ms,
            "plain_ms": plain_ms, "plain_T": T, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None, "render_ms": ms,
            "golden_s": gold_s, "chain_ops": ops, "ns_per_op": ns_op,
            "bytes_ms": bytes_ms, "heap_climbs": kern.heap_climbs,
            "draws": draws, "pool": kern._rand_cap,
            "audio_s_per_s": rates, "files_T": T_files,
            "overtakes_at": over[0] if over else None,
            "sections": sections, "links_ns": links, "priced_chain_ms": priced,
            "sass": sass, "occupancy": occ,
            "gmem_case_max_abs_err": gmem_case_err,
            "gmem_launches": p_launches, "gmem_ms": p_launch_ms[-1],
            "gmem_render_ms": p_ms, "gmem_golden_s": p_gold_s,
            "gmem_max_abs_err": max(prep.max_abs_delta, p_gerr)}


GRAPH_NODES = 4           # builtin_plugins.crossmix_declutter slots
GRAPH_BLOCK = 512         # the reference RenderGraph's default block
GRAPH_PROBE_T = 96_000    # the 3-node graph: 2 s at block 64
GRAPH_TURNS_T = 480_000   # K5's turns on the lockstep: 10 s a render
# the 3-node graph's uncoupled node: a sender on a bus of its own, its
# @block on the host in lockstep (the catalog's IPCProbeA shape)
GRAPH_SENDER_SRC = """\
@init
comm_join("probe");
msg_subscribe("ctl");
gmem_attach("probe");
seq = 0;
@block
seq += 1;
msg_send("ctl", 42, seq, seq * 2, 0, 0);
gmem[5] = seq;
peers = msg_peer_count("ctl", 1);
@sample
spl0 = spl0 * 0.5;
spl1 = spl1 * 0.5;
"""


def graph_held(label, gd, gs, outs_d, outs_s):
    """The device graph gd against the all-shadow graph gs after the same
    renders: each node's audio (AUDIO_EPS), vars and segment cells
    (SCALAR_EPS), the ring's tail (its sequence numbers, senders,
    channels and tags equal, payloads within SCALAR_EPS) and the cursors
    equal; returns the largest audio and value differences."""
    from zorak_tpu_torch.verify import AUDIO_EPS, SCALAR_EPS, compare_audio

    worst_audio = worst_val = 0.0
    for node in gd.nodes:
        rep = compare_audio(outs_s[node.name], outs_d[node.name])
        check(rep.audio_passed, f"graph {label}: node {node.name}: "
              f"{rep.summary()}")
        worst_audio = max(worst_audio, rep.max_abs_delta)
    for i, (ps, pd) in enumerate(zip(gs.plugins, gd.plugins)):
        for k, v in ps.state.V.items():
            if v >= (1 << 40) or v != v:
                continue                        # string handles, NaN
            d = abs(pd.state.V[k] - v)
            check(d <= SCALAR_EPS * max(1.0, abs(v)),
                  f"graph {label}: node {i} var {k}: {pd.state.V[k]} vs {v}")
            worst_val = max(worst_val, d)
    for hs, hd in zip(gs.hosts, gd.hosts):
        if hs.attached_gmem is not None:
            d = float(np.abs(hd.attached_gmem.cells
                             - hs.attached_gmem.cells).max())
            check(d <= SCALAR_EPS, f"graph {label}: segment cells {d:.3e}")
            worst_val = max(worst_val, d)
    for hs, hd in zip(gs.hosts, gd.hosts):
        ring_d = list(hd.domain.ring)
        ring_s = list(hs.domain.ring)[-len(ring_d):] if ring_d else []
        if ring_d:
            check([(m.seq, m.sender, m.dest, m.channel, m.tag)
                   for m in ring_d]
                  == [(m.seq, m.sender, m.dest, m.channel, m.tag)
                      for m in ring_s], f"graph {label}: the ring's tail")
            d = max(abs(a - b) for md, ms in zip(ring_d, ring_s)
                    for a, b in zip(md.scalars, ms.scalars))
            check(d <= SCALAR_EPS, f"graph {label}: ring payloads {d:.3e}")
    check([h.cursor for h in gd.hosts] == [h.cursor for h in gs.hosts],
          f"graph {label}: cursors {[h.cursor for h in gd.hosts]} vs "
          f"{[h.cursor for h in gs.hosts]}")
    return worst_audio, worst_val


def lockstep_tensors(res):
    """`lockstep_gmem_run`'s results as a list of tensors: each member's
    audio and carry (svec, K10's vars and heap, the rings by region), the
    segments, the ring window and its control row."""
    ys, fin, gfin, _mos, msg_fin, _dispatch = res
    out = list(ys)
    for (svec, rings), bvars, bmem in fin:
        out += [svec, bvars, bmem] + [rings[r] for r in sorted(rings)]
    return out + list(gfin) + (list(msg_fin) if msg_fin is not None else [])


def lockstep_recorded(fn):
    """fn() with `lockstep_gmem_run` spied: (fn's result, the tensors of
    each call's results, `lockstep_tensors`)."""
    from zorak_tpu_torch.lowering import specialize as SP

    got, real = [], SP.lockstep_gmem_run

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        got.append(lockstep_tensors(res))
        return res
    SP.lockstep_gmem_run = spy
    try:
        return fn(), got
    finally:
        SP.lockstep_gmem_run = real


def lockstep_same(label, eager, graph):
    """Two renders' outputs and lockstep results (`lockstep_recorded`)
    held `same_values`: audio, carries, segments, window and control
    row."""
    (outs_e, rec_e), (outs_g, rec_g) = eager, graph
    check(len(rec_e) == len(rec_g) == 1 and len(rec_e[0]) == len(rec_g[0])
          and all(same_values(a, b) for a, b in zip(rec_e[0], rec_g[0])),
          f"{label}: the graph's lockstep differs from the eager one's "
          "(audio, carries, segments, window or control row)")
    check(all(np.array_equal(outs_e[k], outs_g[k]) for k in outs_e),
          f"{label}: the graph's outputs differ from the eager one's")


def graph_phase(torch, cuda, rng, card, coupled_k10_ms=None):
    """The render graph: builtin_plugins.crossmix_declutter on 4 nodes x
    60 s at block 512 through RenderGraph (all torch-lockstep, each graph
    block replayed through K5) against the all-shadow graph through the
    native golden; K5 on the lockstep in turns of 10 s (eager, graph,
    graph, eager) on two graphs built alike, each eager render held
    `same_values` to the graph's of the same state, a third graph render
    replaying every graph block, a traced second of each; K10 with the
    staging at each member's first and middle block of the eager turn
    against its plain version, its times and bound; then the 3-node graph
    through K5.  Returns the entries K10's `kernels` line gains."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build
    from zorak_tpu_torch.kernels import block_section as BS
    from zorak_tpu_torch.runtime.graph import RenderGraph

    names = [f"n{i}" for i in range(GRAPH_NODES)]
    progs = [compile_plugin_source(BP.crossmix_declutter(i, GRAPH_NODES))
             for i in range(GRAPH_NODES)]
    x = {nm: (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
         for nm in names}
    lead = 2 * GRAPH_BLOCK                 # a first render that builds all
    x_lead = {nm: (rng.randn(2, lead) * 0.25).astype(np.float32)
              for nm in names}

    def graph(prefer, golden="python"):
        g = RenderGraph(srate=SR, block_size=GRAPH_BLOCK, prefer=prefer,
                        golden=golden)
        for nm, prog in zip(names, progs):
            g.add(nm, prog)
        g.init_all()
        return g

    t0 = time.perf_counter()
    gd = graph("auto")
    check(gd.node_engines == ["torch-lockstep"] * GRAPH_NODES,
          f"graph: engines {gd.node_engines} ({gd.spec_errors})")
    k10s = [k._block_prog for k in gd.kernels]
    check(all(p.staged and p.uses_msg and p.uses_gmem for p in k10s),
          "graph: a member's K10 is not staged for gmem and the bus")
    # the members' K10 builds and a probe build of the first (its latency
    # probe), one nvcc each, all together
    probe = BS.BlockSectionProgram(
        k10s[0].block, k10s[0].slider, k10s[0].n_svec, k10s[0].inter,
        k10s[0].regions, k10s[0].cells, k10s[0].ctrl, probe=True)
    logs = _build.build_generated([p.source for p in k10s] + [probe.source])
    for line in logs[k10s[0].source].splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            print(f"[build] block_section (graph member): {line.strip()}")
    gd.run(x_lead)
    torch.cuda.synchronize()
    check(gd.lockstep_dispatch == "graph",
          f"graph: the lockstep ran as {gd.lockstep_dispatch}")
    print(f"[graph] 4 nodes built, K10 built for each (nvcc together) and a "
          f"{lead}-sample render in {time.perf_counter() - t0:.2f} s; "
          f"K10's phases {[ph.kind for ph in k10s[0].block.phases]}, kept "
          f"on thread 0: {k10s[0].block.serial_loops}")

    # the main render, through the replayed lockstep: the lead render's
    # StepGraphs, its graph blocks new keys (the window's rows W, in the
    # key, grow with the ring's backlog as the render starts)
    blocks = -(-MAIN_T // GRAPH_BLOCK)
    lead_k5 = gd.lockstep_k5
    before = lead_k5.stats()
    k5_set_counts(dict.fromkeys(k5_counts(), 0))
    t0 = time.perf_counter()
    outs_d = gd.run(x)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = k5_counts()
    check(gd.lockstep_dispatch == "graph",
          f"graph: the lockstep ran as {gd.lockstep_dispatch}")
    check(gd.lockstep_k5 is lead_k5 and len(gd._lockstep_graphs) == 1
          and lead_k5.regrowths == 0,
          f"graph: the main render took a StepGraphs of its own or grew a "
          f"static buffer ({len(gd._lockstep_graphs)} StepGraphs, "
          f"{lead_k5.regrowths} regrowths)")
    after = lead_k5.stats()
    main_k5 = {k: after[k] - before[k] for k in
               ("steps", "captures", "capture_seconds", "uncaptured",
                "replays")}
    main_k5["keys"] = after["keys"]
    check(launches["block_section"] == GRAPH_NODES * blocks == 22_500,
          f"graph: K10 launched {launches['block_section']} times for "
          f"{GRAPH_NODES} x {blocks} blocks")
    check(launches["linrec_scan"] > 0 and launches["ring_tap_sum"] > 0,
          f"graph: launches {launches}")
    check(main_k5["steps"] == blocks
          and launches["replays"] == main_k5["replays"]
          == blocks - main_k5["captures"] - main_k5["uncaptured"]
          and main_k5["replays"] > 0,
          f"graph: the main render's graph blocks {main_k5}, replays "
          f"{launches['replays']}")
    for nm in names:
        y = outs_d[nm]
        check(y.shape == (2, MAIN_T) and bool(np.isfinite(y).all()),
              f"graph: node {nm}'s output not finite or of the wrong shape")
    stats = gd.last_ring
    check(stats["overflow"] == 0.0 and not any(stats["drops"]),
          f"graph: the ring window overflowed or a queue dropped: {stats}")
    node_s = GRAPH_NODES * MAIN_T / SR
    print(f"[main] graph crossmix_declutter x{GRAPH_NODES} 60 s stereo, "
          f"block {GRAPH_BLOCK}: engines {gd.node_engines}, lockstep "
          f"dispatch {gd.lockstep_dispatch}, render {render_s:.2f} s "
          f"({render_s * 1e3:.1f} ms) node_audio_s_per_s="
          f"{node_s / render_s:.2f} launches={launches} host_ms_a_block="
          f"{render_s * 1e3 / blocks:.4f}; graph blocks: {main_k5['keys']} "
          f"keys with the lead's, {main_k5['captures']} captured in "
          f"{main_k5['capture_seconds']:.4f} s, {main_k5['uncaptured']} "
          f"uncaptured, {main_k5['replays']} replayed; ring {stats} "
          f"card='{card}'")

    # the all-shadow graph through the native golden, the same renders
    gs = graph("shadow", golden="native")
    gs.run(x_lead)
    t0 = time.perf_counter()
    outs_s = gs.run(x)
    gold_s = time.perf_counter() - t0
    err_audio, err_val = graph_held("crossmix x4", gd, gs, outs_d, outs_s)
    print(f"[main] graph held to the all-shadow native golden graph: audio "
          f"max |delta| {err_audio:.3e}, vars and segment {err_val:.3e}, "
          f"ring tail and cursors equal; the golden graph alone "
          f"{gold_s:.2f} s on the host ({node_s / gold_s:.2f} node-audio-s "
          f"per s)")

    # K5 on the lockstep: two graphs built alike, one rendering eagerly
    # (the yardstick), one through K5, each render of one held
    # `same_values` to the other's of the same state; wall in turns
    label = f"graph lockstep crossmix_declutter x{GRAPH_NODES}"
    turns_T = GRAPH_TURNS_T
    xt = {nm: (rng.randn(2, turns_T) * 0.25).astype(np.float32)
          for nm in names}
    t0 = time.perf_counter()
    ge, gg = graph("auto"), graph("auto")
    lockstep_same("graph lead", lockstep_recorded(
        lambda: ge._run_as("eager", x_lead)), lockstep_recorded(
        lambda: gg.run(x_lead)))
    build_s = time.perf_counter() - t0
    t_blocks = -(-turns_T // GRAPH_BLOCK)
    mid = t_blocks // 2
    wanted = {b * GRAPH_NODES + j for b in (0, mid)
              for j in range(GRAPH_NODES)}
    got, spy, real = k10_recording(wanted)
    walls = {"eager": [], "graph": []}
    turns = {}
    k5_set_counts(dict.fromkeys(k5_counts(), 0))
    for nth, (g, step) in enumerate(((ge, "eager"), (gg, None),
                                     (gg, None), (ge, "eager"))):
        # K10's inputs kept from the first eager turn (a replay calls no
        # wrapper; the copies are made between launches, outside the count)
        if nth == 0:
            BS.block_section = spy
        try:
            t0 = time.perf_counter()
            turns[nth] = lockstep_recorded(lambda g=g, step=step:
                                           g._run_as(step, xt))
            torch.cuda.synchronize()
            walls[step or "graph"].append(time.perf_counter() - t0)
        finally:
            BS.block_section = real
        check(g.lockstep_dispatch == ("graph" if step is None else
                                      "eager: the eager step, asked for"),
              f"{label}: turn {nth} ran as {g.lockstep_dispatch}")
        if nth == 1:
            k5g = gg.lockstep_k5
            first_k5 = k5g.stats()
    turn_counts = k5_counts()
    lockstep_same(f"{label} first turns", turns[0], turns[1])
    lockstep_same(f"{label} second turns", turns[3], turns[2])
    check(turn_counts["block_section"] == 4 * GRAPH_NODES * t_blocks,
          f"{label}: K10 launched {turn_counts['block_section']} times in "
          f"four turns of {t_blocks} blocks")
    # a key is captured the second time it is seen: the third render
    # replays every graph block
    st2 = k5g.stats()
    gg.run(xt)
    torch.cuda.synchronize()
    st3 = k5g.stats()
    check(gg.lockstep_k5 is k5g and st3["captures"] == st2["captures"]
          and st3["uncaptured"] == st2["uncaptured"]
          and st3["replays"] - st2["replays"] == t_blocks,
          f"{label}: the third render replayed "
          f"{st3['replays'] - st2['replays']} of {t_blocks} graph blocks "
          f"({st3['captures'] - st2['captures']} captures, "
          f"{st3['uncaptured'] - st2['uncaptured']} uncaptured)")
    # what a render costs besides its graph blocks: a one-block render
    # (the members' carries loaded into the static buffers and cloned
    # out, the host's state written back), replayed
    x_one = {nm: a[:, :GRAPH_BLOCK] for nm, a in xt.items()}
    gg.run(x_one)
    t0 = time.perf_counter()
    gg.run(x_one)
    torch.cuda.synchronize()
    one_block_s = time.perf_counter() - t0
    eager_ms = 1e3 * min(walls["eager"]) / t_blocks
    replay_ms = 1e3 * min(walls["graph"]) / t_blocks
    print(f"[k5] {label}: {turns_T / SR:g} s in {t_blocks} graph blocks; "
          f"two graphs built alike and a lead render each in {build_s:.2f} "
          f"s; eager and graph renders of the same state same_values "
          f"(audio, carries, segments, window, control row), twice; the "
          f"first graph render captured {first_k5['captures']} in "
          f"{first_k5['capture_seconds']:.4f} s ({first_k5['uncaptured']} "
          f"uncaptured, {first_k5['keys']} keys), the third replayed all "
          f"{t_blocks}; wall in turns: eager "
          f"{' '.join(f'{w:.4f}' for w in walls['eager'])}, graph "
          f"{' '.join(f'{w:.4f}' for w in walls['graph'])} s ({eager_ms:.4f} "
          f"against {replay_ms:.4f} ms a graph block); a one-block render "
          f"{one_block_s:.4f} s card='{card}'")

    # a traced second of each: host operations, device events and busy
    # time a graph block, the idle share, the kernels by name
    n1 = int(SR)
    x1 = {nm: a[:, :n1] for nm, a in xt.items()}
    blocks1 = -(-n1 // GRAPH_BLOCK)
    for _ in range(2):
        gg.run(x1)
    torch.cuda.synchronize()
    tr_g, tr_e, expected = k5_traces(
        torch, label, lambda step, _n: (gg if step is None else ge)._run_as(
            step, x1), n1, blocks1)
    pool = k5g.pool_bytes()
    total = k5g.stats()
    # the device's time of a full graph block: its capture replayed back
    # to back on the static buffers (a render loads them again).  One
    # capture a window size W (in the key; the lead render's ring started
    # empty), the last render's replayed last
    full = [(k, v[0]) for k, v in k5g.graphs.items()
            if k[1] == GRAPH_BLOCK]
    check(full and len(full) == len({k[2] for k, _g in full}),
          f"{label}: {len(full)} captures of a full block for window sizes "
          f"{sorted({k[2] for k, _g in full})}")
    full[-1][1].replay()
    replay_dev_ms = cuda_ms(full[-1][1].replay, reps=200)
    print(f"[k5] {label}: a traced {n1 / SR:g} s ({blocks1} graph blocks): "
          f"host operations a graph block {tr_g['host_ops']:.2f} "
          f"({tr_g['ranges']} ranges) against {tr_e['host_ops']:.2f} "
          f"eager; device events a graph block {tr_g['device_events']:.1f} "
          f"against {tr_e['device_events']:.1f}; busy "
          f"{tr_g['busy_ms']:.4f} against {tr_e['busy_ms']:.4f} ms a graph "
          f"block, of it the render's copies {tr_g['copies_ms']:.4f} and "
          f"{tr_e['copies_ms']:.4f}; a full graph block's replay alone "
          f"{replay_dev_ms:.4f} ms of device time (CUDA events, 200 back "
          f"to back); idle share "
          + (f"{tr_g['idle']:.3f}" if tr_g["idle"] is not None else "not "
             "measured") + " against "
          + (f"{tr_e['idle']:.3f}" if tr_e["idle"] is not None else "not "
             "measured")
          + "; the captures' pool "
          + (f"{pool} bytes" if pool is not None else "not measured")
          + f", static buffers {total['buffer_bytes']} bytes; "
          f"{total['captures']} captures in "
          f"{total['capture_seconds']:.4f} s, {total['keys']} keys; kernels "
          f"on the card by name {tr_g['families']} replayed, "
          f"{tr_e['families']} eager, {expected} from LAUNCHES "
          f"card='{card}'")
    check(tr_g["host_ops"] <= 4.0, f"{label}: {tr_g['host_ops']:.2f} host "
          "operations a graph block through K5")
    K5_ROWS.append({
        "label": label, "T": MAIN_T, "steps": blocks,
        "members": GRAPH_NODES, "main_s": render_s,
        "main_captures": main_k5["captures"],
        "main_capture_s": main_k5["capture_seconds"],
        "main_replays": main_k5["replays"], "keys": main_k5["keys"],
        "turns_T": turns_T, "turns_eager_s": walls["eager"],
        "turns_graph_s": walls["graph"], "eager_ms_a_step": eager_ms,
        "graph_ms_a_step": replay_ms, "replay_device_ms": replay_dev_ms,
        "one_block_render_s": one_block_s,
        "first_turn_captures": first_k5["captures"],
        "first_turn_capture_s": first_k5["capture_seconds"],
        "traced_T": n1, "graph_trace": tr_g, "eager_trace": tr_e,
        "pool_bytes": pool, "launches": launches,
        "kernels_from_launches": expected,
        "buffer_bytes": total["buffer_bytes"],
        "kernel_captures": total["captures"],
        "kernel_capture_s": total["capture_seconds"], "card": card})

    # K10 with the staging against its plain version, each member's first
    # and middle block of the eager turn
    plain_ms = []
    err = 0.0
    for key in sorted(got):
        e, p_ms = k10_plain_held(got[key], f"graph: K10 member "
                                 f"{key % GRAPH_NODES} block "
                                 f"{key // GRAPH_NODES}")
        err = max(err, e)
        plain_ms.append(p_ms)
    check(len(got) == len(wanted), f"graph: K10 recorded at {sorted(got)}")
    print(f"[graph] K10 with the staging at the first and middle block of "
          f"each of the {GRAPH_NODES} members (the eager turn): "
          f"bit-identical to the plain version (vars, heap with queues, OUT "
          f"table and gmem window, segment, ring window, count and cursors, "
          f"control row, rings); plain version {min(plain_ms):.1f} to "
          f"{max(plain_ms):.1f} ms")

    # K10 a launch at member 0's middle block, and its bound
    st = got[mid * GRAPH_NODES].stage
    work = got[mid * GRAPH_NODES].copy()
    program, sb, st_t = work.program, work.sb, work.stage
    args = [work.svec, work.rings, work.bvars, work.bmem]
    reps = 50
    BS.block_section(program, *args, sb, stage=st_t)        # loads it
    # the device's time a launch (20 launches replayed from a CUDA graph),
    # and the host-paced rate of eager launches
    k10_ms = graph_ms(lambda: BS.block_section(program, *args, sb,
                                               stage=st_t))
    k10_eager_ms = cuda_ms(lambda: BS.block_section(program, *args, sb,
                                                    stage=st_t), reps=reps)
    lat = torch.zeros(1, dtype=torch.float64, device=cuda)
    n_lat = 1 << 16
    BS.block_section_latency_probe(probe, lat, 16)
    add_ns = cuda_ms(lambda: BS.block_section_latency_probe(
        probe, lat, n_lat)) * 1e6 / n_lat
    # this launch's work: the window rows the prologue walks and routes,
    # the rows the epilogue appends, the queues and OUT table, the
    # segment's cells the section reads and writes, the exchanges
    ctl0, win0 = st.ctl.cpu().numpy(), st.window.cpu().numpy()
    sub0 = st.sub.cpu().numpy()
    dev = program.block
    cur0 = int(ctl0[BS.CTL_CURSORS + st.member])
    walked = int(ctl0[BS.CTL_COUNT]) - cur0
    rows0 = win0[cur0:int(ctl0[BS.CTL_COUNT])]
    heard = int(sum(1 for r in rows0 if r[1] > 0.5 and r[0] != st.my_id
                    and sub0[int(r[3])] != 0.0))
    sent = 1                               # msg_send once a block
    seg_cells = 2 * GRAPH_NODES            # gmem[slot] written, NS read
    n_inter = len(program.inter) + len(program.cells)
    ring_cells = sum(m for _o, m in program.regions)
    nbytes = 8 * (BS.WINDOW_ENT * (walked + sent) + 6 * 2 * heard
                  + 8 * 2 * sent + seg_cells
                  + 2 * (n_inter + ring_cells) + len(program.ctrl)
                  + 2 * program.n_vars)
    # thread 0's chain: a dependent step a walked row, routed row and
    # appended row, three a slot of the loop over the slots, three a
    # received message (pop, compare, add), one a top-level statement
    chain_ops = walked + heard + sent + 3 * GRAPH_NODES + 3 * heard \
        + len(dev.body)
    chain_ms = chain_ops * add_ns / 1e6
    bytes_ms, _by = bound_ms(nbytes, 0)
    graph_bound = max(bytes_ms, chain_ms)
    graph_by = "bytes" if bytes_ms >= chain_ms else "operations"
    print(f"[graph] K10 a launch in the graph (member 0, block {mid}'s "
          f"inputs, a CUDA graph of 20): {k10_ms * 1e3:.2f} us; eager, mean "
          f"of {reps}: {k10_eager_ms * 1e3:.2f} us"
          + (f", beside the coupled phase's {coupled_k10_ms * 1e3:.2f} us"
             if coupled_k10_ms is not None else "")
          + f"; bound {graph_bound * 1e3:.4f} us by {graph_by} ({nbytes} "
          f"bytes: {walked} window rows walked, {heard} routed, {sent} "
          f"appended; thread 0's chain {chain_ops} dependent f64 operations "
          f"at {add_ns:.2f} ns) card='{card}'")

    # the 3-node graph: a coupled lockstep pair beside an uncoupled node
    # on a bus of its own, 2 s at block 64, its pair through K5
    small = [("a", BP.crossmix_declutter(0, 2)),
             ("b", BP.crossmix_declutter(1, 2)), ("tx", GRAPH_SENDER_SRC)]
    xs = {nm: (rng.randn(2, GRAPH_PROBE_T) * 0.25).astype(np.float32)
          for nm, _src in small}
    res = {}
    for prefer, golden in (("auto", "python"), ("shadow", "native")):
        g = RenderGraph(srate=SR, block_size=64, prefer=prefer,
                        golden=golden)
        for nm, src in small:
            g.add(nm, compile_plugin_source(src))
        g.init_all()
        k5_set_counts(dict.fromkeys(k5_counts(), 0))
        t0 = time.perf_counter()
        outs = g.run(xs)
        torch.cuda.synchronize()
        res[prefer] = (g, outs, time.perf_counter() - t0, k5_counts())
    g3, outs3, s3, counts3 = res["auto"]
    check(g3.node_engines == ["torch-lockstep", "torch-lockstep",
                              "torch-vector"],
          f"graph 3 nodes: engines {g3.node_engines} ({g3.spec_errors})")
    blocks3 = -(-GRAPH_PROBE_T // 64)
    k10_3 = counts3["block_section"]
    check(k10_3 == 2 * blocks3, f"graph 3 nodes: K10 launched {k10_3}")
    st_3 = g3.lockstep_k5.stats()
    check(g3.lockstep_dispatch == "graph" and counts3["replays"]
          == st_3["replays"] == blocks3 - st_3["captures"]
          - st_3["uncaptured"] > 0,
          f"graph 3 nodes: the lockstep ran as {g3.lockstep_dispatch}, "
          f"{st_3}, replays {counts3['replays']}")
    err3 = graph_held("3 nodes", g3, res["shadow"][0], outs3,
                      res["shadow"][1])
    check(g3.plugins[2].state.V["seq"] == float(blocks3),
          "graph 3 nodes: the host-lockstep sender's @block ran "
          f"{g3.plugins[2].state.V['seq']} times")
    print(f"[graph] 3 nodes (a lockstep pair beside a host-lockstep sender) "
          f"2 s at block 64: engines {g3.node_engines}, lockstep dispatch "
          f"{g3.lockstep_dispatch}, {st_3['replays']} of {blocks3} graph "
          f"blocks replayed ({st_3['captures']} captured, "
          f"{st_3['uncaptured']} uncaptured), K10 {k10_3} launches, "
          f"{s3:.2f} s on the card, the golden graph "
          f"{res['shadow'][2]:.2f} s; held to the native golden graph "
          f"(audio {err3[0]:.3e}, vars and segments {err3[1]:.3e})")
    return {
        "launches_graph": launches["block_section"],
        "graph_ms_a_launch": k10_ms, "graph_eager_ms_a_launch": k10_eager_ms,
        "graph_plain_ms": float(np.median(
            plain_ms)), "graph_bound_ms": graph_bound,
        "graph_bound_by": graph_by, "graph_max_abs_err": err,
        "graph_render_s": render_s, "graph_golden_s": gold_s,
        "graph_node_audio_s_per_s": node_s / render_s,
        "graph_host_ms_a_block": render_s * 1e3 / blocks,
        "graph_replays": launches["replays"],
        "graph_turn_eager_ms_a_block": eager_ms,
        "graph_turn_replay_ms_a_block": replay_ms,
        "graph_host_ops_a_block": tr_g["host_ops"],
        "graph_replay_device_ms": replay_dev_ms,
        "graph_events_a_block": tr_g["device_events"],
        "graph_idle": tr_g["idle"],
        "graph_launches_linrec_scan": launches["linrec_scan"],
        "graph_launches_ring_tap_sum": launches["ring_tap_sum"],
        "graph_add_ns": add_ns, "graph_chain_ops": chain_ops,
        "graph3_render_s": s3, "graph3_launches": k10_3,
        "graph3_replays": counts3["replays"],
    }


def smi_under_load(torch, fn, reps: int) -> str:
    """nvidia-smi's SM clock, power draw and power limit, read while the
    card works through `reps` queued calls of fn."""
    for _ in range(reps):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return smi


def k8_at_the_bench(torch, CV, xb, ir_np, n, held, timed, entry):
    """K8 on the bench's input spectra and IR partitions: held to its
    plain version (every tile, scale 1 and irfft's 1/N) and the earlier
    design to it; the partitioned convolution's new form (1/N folded into
    K8) against its old form bit for bit; the tiles swept; this design
    and the earlier one timed in turns (earlier, this, this, earlier)
    beside nvidia-smi's SM clock under load; the library call (a grouped
    complex conv1d, a group a bin, TF32 off) timed and compared.  Fills
    K8's entry."""
    F = torch.nn.functional
    h = CV.ir_spectra(torch.from_numpy(ir_np).to(xb.device), PART)
    X = CV.input_spectra(xb, PART).contiguous()
    parts, bins = h.shape
    Y = CV.partition_mac(X, h)
    ref = CV.partition_mac_reference(X, h)
    held("K8 at the bench shape", Y, ref)
    scale = 1.0 / (2 * PART)
    held("K8 with irfft's 1/N at the bench shape",
         CV.partition_mac(X, h, scale),
         torch.view_as_complex(torch.view_as_real(ref) * scale))
    for tile in CV.TILES[1:]:
        held(f"K8 tile {tile} at the bench shape",
             CV.partition_mac(X, h, tile=tile), ref)
    del ref

    lib = CV._library()
    lib.zorak_partition_mac_earlier.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.zorak_partition_mac_earlier.restype = ctypes.c_int
    y_old = torch.empty_like(X)
    stream = torch.cuda.current_stream().cuda_stream

    def earlier():
        err = lib.zorak_partition_mac_earlier(
            X.data_ptr(), h.data_ptr(), y_old.data_ptr(), *X.shape, parts,
            stream)
        check(err == 0, f"K8's earlier design: launch failed, cudaError {err}")

    earlier()
    held("K8's earlier design at the bench shape", y_old, Y)

    # the convolution: 1/N in K8's store against irfft's own, bit for bit
    new = CV.partitioned_convolve(xb, torch.from_numpy(ir_np).to(xb.device),
                                  PART)
    old = CV.overlap_save_crop(torch.fft.irfft(Y, 2 * PART, dim=-1), n)
    check(same_bits(new, old), "partitioned_convolve: 1/N folded into K8 "
          "differs from irfft's own 1/N")
    print("[spectral] partitioned_convolve at the bench shape: 1/N folded "
          "into K8 bit-identical to irfft's own 1/N")
    y_max = float(Y.abs().max())
    del new, old, Y

    macs = X.numel() * parts
    ops_ms = MAC_INSTR * macs / F32_INSTR_PER_S * 1e3
    sweep = {}
    for tile in CV.TILES:
        sweep[str(tile)] = timed(lambda: CV.partition_mac(X, h, tile=tile))
        print(f"[spectral] K8 tile (R, W, PG) = {tile}: "
              f"{sweep[str(tile)]:.4f} ms, {ops_ms / sweep[str(tile)]:.1%} "
              f"of the operations bound")
    turns = [timed(earlier), timed(lambda: CV.partition_mac(X, h)),
             timed(lambda: CV.partition_mac(X, h)), timed(earlier)]
    smi = smi_under_load(torch, lambda: CV.partition_mac(X, h), 1500)
    ms, earlier_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    print(f"[spectral] K8 in turns (earlier, this, this, earlier): "
          f"{', '.join(f'{t:.4f}' for t in turns)} ms; this design "
          f"{ms:.4f} ms against {earlier_ms:.4f} ms, {ops_ms / ms:.1%} of "
          f"the operations bound; under load clocks.sm, power.draw, "
          f"power.limit = {smi}")
    del y_old

    # the library yardstick: one grouped complex conv1d, input laid out
    # beforehand, TF32 off (cuDNN's default for f32 convolutions is on)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xin = F.pad(X.permute(0, 2, 1), (parts - 1, 0)).contiguous()
        wt = h.T.flip(-1).unsqueeze(1).contiguous()
        y_lib = F.conv1d(xin, wt, groups=bins).permute(0, 2, 1)
        lib_err = float((y_lib - CV.partition_mac(X, h)).abs().max())
        del y_lib
        library_ms = timed(lambda: F.conv1d(xin, wt, groups=bins), 3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del xin
    print(f"[spectral] K8's library call, grouped complex conv1d (cudnn "
          f"allow_tf32 {tf32} by default, False for the call): "
          f"{library_ms:.4f} ms, max |delta| from the kernel {lib_err:.3e} "
          f"(max |Y| {y_max:.1f}: another summing order)"
          f"{'; it beats the kernel' if library_ms < ms else ''}")
    entry("partition_mac", "zorak_tpu/kernels/convolution.py:73-80", "K8",
          ms, timed(lambda: CV.partition_mac_reference(X, h), 3),
          8.0 * (2 * X.numel() + h.numel()), MAC_INSTR * macs, library_ms,
          X.shape + (parts,), complex_macs=macs, earlier_ms=earlier_ms,
          turns_ms=turns, tile_sweep_ms=sweep, default_tile=list(CV.TILES[0]),
          smi_under_load=smi, library_max_abs_delta=lib_err)


def spectral_phase(torch, cuda, rng, card):
    """The spectral and convolution slice (BASELINE configs 2-4): K7a,
    K7b, K7c and K8 against their plain versions bit for bit, at odd
    shapes and at the bench's; their times beside bounds, plain versions
    and library calls; the three bench sections through
    zorak_tpu_torch.bench (launch counts a section call, the _rtx
    figures); the pipelines against the port's CPU render, and the
    convolution against scipy in f64.  Returns the four `kernels`
    entries."""
    import importlib

    import scipy.signal

    from zorak_tpu_torch import bench as BN
    from zorak_tpu_torch.kernels import convolution as CV
    from zorak_tpu_torch.verify import AUDIO_EPS

    ST = importlib.import_module("zorak_tpu_torch.kernels.stft")
    F = torch.nn.functional

    def bits_equal(a, b):
        """Kernel vs plain: every bit, every NaN one value (complex as
        real and imaginary parts)."""
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        return same_values(a.contiguous(), b.contiguous())

    def held(what, got, want):
        check(bits_equal(got, want), f"{what}: kernel differs from its "
              "plain version")

    def timed(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        return cuda_ms(fn, reps=reps)

    def wsum_of(t, size, hop):
        w = np.hanning(size).astype(np.float32)
        n_frames = ST._n_frames(t, size, hop)
        return ST._ola_window_norm(w, n_frames, size, hop)[:t].astype(
            np.float64)

    def audio_held(what, got, want, size, hop):
        """CUDA against the CPU render: the OLA sum (y x wsum) within
        AUDIO_EPS everywhere, y within it where wsum >= WSUM_MIN."""
        wsum = wsum_of(got.shape[-1], size, hop)
        d = np.abs(got.astype(np.float64) - want.astype(np.float64))
        err_sum = float((d * wsum).max())
        err = float(d[..., wsum >= WSUM_MIN].max())
        print(f"[spectral] {what}: CUDA vs CPU render max |delta| {err:.3e} "
              f"where wsum >= {WSUM_MIN}, of the OLA sum {err_sum:.3e} "
              f"(limit {AUDIO_EPS})")
        check(err <= AUDIO_EPS and err_sum <= AUDIO_EPS,
              f"{what}: CUDA render disagrees with the CPU render")
        return err

    # -- odd shapes, bit for bit ----------------------------------------------
    for lanes, t, size, hop in K7_ODD:
        x = torch.from_numpy((rng.randn(lanes, t) * 0.25).astype(np.float32))
        x[0, :3] = torch.tensor([float("nan"), -0.0, float("inf")])
        w = torch.from_numpy(np.hanning(size).astype(np.float32))
        xc, wc = x.to(cuda), w.to(cuda)
        frames = ST.frame_window(xc, wc, size, hop)
        held(f"K7a {lanes}x{t} size {size} hop {hop}", frames,
             ST.frame_window_reference(xc, wc, size, hop))
        check(torch.equal(torch.isnan(frames.cpu()), torch.isnan(
            ST.frame_window(x, w, size, hop))), "K7a: NaN elsewhere than "
              "on the CPU")
        n_frames = frames.shape[1]
        fr = torch.randn(lanes, n_frames, size, device=cuda) * 100
        fr[0, 0, 1] = -0.0
        inv = torch.from_numpy(ST._inv_wsum(w.numpy().tobytes(), n_frames,
                                            size, hop)).to(cuda)
        for t_out in {t, (n_frames - 1) * hop + size}:
            held(f"K7b {lanes}x{n_frames}x{size} hop {hop} to {t_out}",
                 ST.overlap_add_norm(fr, wc, inv, hop, t_out),
                 ST.overlap_add_norm_reference(fr, wc, inv, hop, t_out))
        bins = size // 2 + 1
        spec = torch.complex(torch.randn(lanes, n_frames, bins, device=cuda),
                             torch.randn(lanes, n_frames, bins, device=cuda))
        spec[0, 0, 0] = complex(float("nan"), 1.0)
        thr = torch.rand(lanes, device=cuda) * 2
        thr[-1] = 0.0
        for floor_db in (-24.0, -60.0):
            held(f"K7c {lanes}x{n_frames}x{bins} floor {floor_db}",
                 ST.gate_gain(spec, thr, floor_db),
                 ST.gate_gain_reference(spec, thr, floor_db))
    nan_thr = torch.tensor([float("nan"), 0.5], device=cuda)
    spec2 = torch.randn(2, 3, 17, dtype=torch.complex64, device=cuda)
    held("K7c NaN threshold", ST.gate_gain(spec2, nan_thr, -24.0),
         ST.gate_gain_reference(spec2, nan_thr, -24.0))
    for lanes, n_frames, bins, parts in K8_ODD:
        x = torch.randn(lanes, n_frames, bins, dtype=torch.complex64,
                        device=cuda)
        x[-1, 0, 0] = complex(float("nan"), -0.0)
        h = torch.randn(parts, bins, dtype=torch.complex64, device=cuda) * 30
        h[0, 1] = complex(float("inf"), 0.0)   # the zero rows meet it
        for scale in (1.0, 2.0 ** -12):
            want = CV.partition_mac_reference(x, h, scale)
            for tile in CV.TILES:
                held(f"K8 {lanes}x{n_frames}x{bins} {parts} parts scale "
                     f"{scale} tile {tile}",
                     CV.partition_mac(x, h, scale, tile), want)
    print(f"[spectral] K7a, K7b, K7c and K8 bit-identical to their plain "
          f"versions at {len(K7_ODD)} + {len(K8_ODD)} odd shapes (K8: "
          f"every tile of {CV.TILES}, scale 1 and 2^-12)")

    # the pipelines at odd shapes against the port's CPU render
    for lanes, t, size, hop in K7_ODD:
        x = (rng.randn(lanes, t) * 0.25).astype(np.float32)
        x1 = x[0] if lanes == 1 else x               # [T] and [lanes, T]
        cpu = ST.stft_process(torch.from_numpy(x1), lambda s: s * 0.5, size,
                              hop).numpy()
        got = ST.stft_process(torch.from_numpy(x1).to(cuda),
                              lambda s: s * 0.5, size, hop).cpu().numpy()
        audio_held(f"stft_process {x1.shape} size {size} hop {hop}", got,
                   cpu, size, hop)
        xq = x1 * np.float32(0.1)
        cpu = ST.spectral_gate(torch.from_numpy(xq), size=size,
                               hop=hop).numpy()
        got = ST.spectral_gate(torch.from_numpy(xq).to(cuda), size=size,
                               hop=hop).cpu().numpy()
        audio_held(f"spectral_gate {x1.shape} size {size} hop {hop}", got,
                   cpu, size, hop)
    for lanes, t, k, b in CONV_ODD:
        x = (rng.randn(*((t,) if lanes is None else (lanes, t)))
             ).astype(np.float32)
        ir = (rng.randn(k) * np.exp(-np.arange(k) / (k / 4))).astype(
            np.float32)
        cpu = CV.partitioned_convolve(torch.from_numpy(x), ir, b).numpy()
        got = CV.partitioned_convolve(torch.from_numpy(x).to(cuda), ir,
                                      b).cpu().numpy()
        scale = max(1.0, float(np.abs(cpu).max()))
        err = float(np.abs(got - cpu).max())
        ref = np.stack([scipy.signal.fftconvolve(
            r.astype(np.float64), ir.astype(np.float64))[:t]
            for r in x.reshape(-1, t)]).reshape(x.shape)
        err_ref = float(np.abs(got - ref).max())
        check(err <= AUDIO_EPS * scale and err_ref <= 2e-5 * max(
            1.0, float(np.abs(ref).max())),
            f"partitioned_convolve {x.shape} k {k} B {b}: {err:.3e} from "
            f"the CPU render, {err_ref:.3e} from scipy")
    print(f"[spectral] stft_process, spectral_gate ({len(K7_ODD)} shapes) "
          f"and partitioned_convolve ({len(CONV_ODD)}) on the card held to "
          "the CPU render; the convolution also to scipy in f64")

    # -- the bench's shapes: held, timed, bounded ------------------------------
    n = int(BN.KERNEL_SECONDS * BN.SRATE)
    lanes = BN.LANES
    src = np.random.RandomState(11)
    xb = torch.from_numpy((src.randn(lanes, n) * 0.25).astype(np.float32)).to(
        cuda)
    ir_np = BN.section_ir(src)      # drawn after the input, as bench.py does
    w_np = np.hanning(SPEC_SIZE).astype(np.float32)
    w = torch.from_numpy(w_np).to(cuda)
    entries = {}

    def entry(name, replaces, what, ms, plain_ms, nbytes, ops, library_ms,
              shape, **extra):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_INSTR_PER_S * 1e3
        b_ms, b_by = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                      else (ops_ms, "operations"))
        lib = ("none (no one PyTorch call computes it)" if library_ms is None
               else f"{library_ms:.4f}")
        print(f"[spectral] {name} ({what}) {shape}: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={b_ms:.4f} "
              f"({b_by}; bytes {bytes_ms:.4f}, operations {ops_ms:.4f}) "
              f"card='{card}'")
        entries[name] = {
            "name": name, "route": "cuda", "source": f"zorak_tpu_torch/csrc/"
            f"{'partition_mac' if name == 'partition_mac' else 'stft_ola'}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "shape": list(shape),
            **extra}

    # K7a
    n_frames = ST._n_frames(n, SPEC_SIZE, SPEC_HOP)
    frames = ST.frame_window(xb, w, SPEC_SIZE, SPEC_HOP)
    held("K7a at the bench shape", frames,
         ST.frame_window_reference(xb, w, SPEC_SIZE, SPEC_HOP))
    pad = (n_frames - 1) * SPEC_HOP + SPEC_SIZE - n

    def unfold_window():
        return F.pad(xb, (0, pad)).unfold(-1, SPEC_SIZE, SPEC_HOP) * w

    entry("frame_window", "zorak_tpu/kernels/stft.py:35", "K7a",
          timed(lambda: ST.frame_window(xb, w, SPEC_SIZE, SPEC_HOP)),
          timed(lambda: ST.frame_window_reference(xb, w, SPEC_SIZE,
                                                  SPEC_HOP), 3),
          4.0 * (xb.numel() + SPEC_SIZE + frames.numel()), frames.numel(),
          timed(unfold_window, 3), frames.shape)
    # K7b on the irFFT of the bench's spectra
    spec = torch.fft.rfft(frames, dim=-1)
    del frames
    fr = torch.fft.irfft(spec, SPEC_SIZE, dim=-1).contiguous()
    del spec
    total = (n_frames - 1) * SPEC_HOP + SPEC_SIZE
    inv = torch.from_numpy(ST._inv_wsum(w_np.tobytes(), n_frames, SPEC_SIZE,
                                        SPEC_HOP)).to(cuda)
    y = ST.overlap_add_norm(fr, w, inv, SPEC_HOP, n)
    held("K7b at the bench shape", y,
         ST.overlap_add_norm_reference(fr, w, inv, SPEC_HOP, n))

    def fold_norm():
        ola = F.fold((fr * w).transpose(1, 2), (1, total), (1, SPEC_SIZE),
                     stride=(1, SPEC_HOP))
        return (ola.reshape(lanes, total) * inv)[:, :n]

    fold_err = float((fold_norm() - y).abs().max())
    entry("overlap_add_norm", "zorak_tpu/kernels/stft.py:61", "K7b",
          timed(lambda: ST.overlap_add_norm(fr, w, inv, SPEC_HOP, n)),
          timed(lambda: ST.overlap_add_norm_reference(fr, w, inv, SPEC_HOP,
                                                      n), 3),
          4.0 * (fr.numel() + SPEC_SIZE + total + y.numel()),
          2.0 * fr.numel() + y.numel(), timed(fold_norm, 3), fr.shape,
          library_max_abs_delta=fold_err)
    print(f"[spectral] K7b: F.fold x 1/wsum differs from the kernel by "
          f"{fold_err:.3e} (another summing order)")
    del fr, y
    # K7c on the denoiser's spectra and thresholds
    xq = torch.from_numpy((np.random.RandomState(11).randn(lanes, n) * 0.02
                           ).astype(np.float32)).to(cuda)
    spec = torch.fft.rfft(ST.frame_window(xq, w, SPEC_SIZE, SPEC_SIZE // 2),
                          dim=-1)
    quiet = ST.percentile(ST.magnitude(spec), 10.0, dim=-2)
    thr = torch.clamp_min(ST.median(quiet), float(
        np.float32(10.0 ** (-50.0 / 20.0)))) * 4.0
    del quiet
    held("K7c at the bench shape", ST.gate_gain(spec, thr, -24.0),
         ST.gate_gain_reference(spec, thr, -24.0))
    entry("gate_gain", "zorak_tpu/kernels/stft.py:126", "K7c",
          timed(lambda: ST.gate_gain(spec, thr, -24.0)),
          timed(lambda: ST.gate_gain_reference(spec, thr, -24.0), 3),
          16.0 * spec.numel() + 4.0 * lanes, 16.0 * spec.numel(), None,
          spec.shape)
    del spec, xq
    # K8 on the bench's input spectra and IR partitions
    k8_at_the_bench(torch, CV, xb, ir_np, n, held, timed, entry)
    torch.cuda.empty_cache()

    # -- the main path: the three bench sections --------------------------------
    for k in ST.LAUNCHES:
        ST.LAUNCHES[k] = 0
    CV.LAUNCHES = 0
    calls = 4                       # _timed: a warm-up, then the best of 3
    rtx, per_call = {}, {}
    for section, kernels_run in (("stft", ("frame_window", "overlap_add_norm")),
                                 ("denoiser", ("frame_window",
                                               "overlap_add_norm",
                                               "gate_gain")),
                                 ("convolution", ("partition_mac",))):
        before = dict(ST.LAUNCHES, partition_mac=CV.LAUNCHES)
        t0 = time.perf_counter()
        rtx.update(BN.SECTIONS[section](cuda))
        torch.cuda.empty_cache()
        after = dict(ST.LAUNCHES, partition_mac=CV.LAUNCHES)
        ran = {k: after[k] - before[k] for k in after}
        per_call[section] = {k: v / calls for k, v in ran.items() if v}
        check(all(ran[k] == calls for k in kernels_run) and
              sum(ran.values()) == calls * len(kernels_run),
              f"bench section {section}: launches {ran}, expected one of "
              f"each of {kernels_run} a call x {calls} calls")
        print(f"[spectral] bench section {section}: launches a call "
              f"{per_call[section]} ({time.perf_counter() - t0:.1f} s)")
    launches = dict(ST.LAUNCHES, partition_mac=CV.LAUNCHES)
    for name, e in entries.items():
        e["launches"] = launches[name]
        e["launches_per_section_call"] = {
            s: c[name] for s, c in per_call.items() if name in c}
    print(f"[spectral] {json.dumps(rtx)} card='{card}'")

    def tilt(spec):
        return spec * torch.linspace(0.5, 1.5, spec.shape[-1],
                                     device=spec.device)

    # -- where a section's time goes: one call of each pipeline, traced -------
    xq = torch.from_numpy((np.random.RandomState(11).randn(lanes, n) * 0.02
                           ).astype(np.float32))
    xq_dev, ir_dev = xq.to(cuda), torch.from_numpy(ir_np).to(cuda)
    for section, call in (
            ("stft", lambda: ST.stft_process(xb, tilt, SPEC_SIZE, SPEC_HOP)),
            ("denoiser", lambda: ST.spectral_gate(xq_dev, size=SPEC_SIZE)),
            ("convolution", lambda: CV.partitioned_convolve(xb, ir_dev,
                                                            PART))):
        call()
        names = profile_render(call, f"bench section {section}")[1]
    # irfft runs unscaled: its 1/N is K8's (no multiply pass left)
    check(any("partition_mac_kernel" in k for k in names) and not any(
        "MulFunctor" in k for k in names), f"the convolution's trace: "
          f"K8 missing or a multiply pass left: {sorted(names)}")
    print("[spectral] the convolution's trace holds K8 and no multiply "
          "pass (irfft's 1/N is K8's)")
    del xq_dev
    torch.cuda.empty_cache()

    # -- the bench's pipelines against the port's CPU render (lanes 0, 31) ----
    keep = [0, lanes - 1]
    x_cpu = xb[keep].cpu()

    got = ST.stft_process(xb, tilt, SPEC_SIZE, SPEC_HOP)[keep].cpu().numpy()
    audio_held("stft_process at the bench shape", got,
               ST.stft_process(x_cpu, tilt, SPEC_SIZE, SPEC_HOP).numpy(),
               SPEC_SIZE, SPEC_HOP)
    got = ST.spectral_gate(xq.to(cuda), size=SPEC_SIZE)[keep].cpu().numpy()
    audio_held("spectral_gate at the bench shape", got,
               ST.spectral_gate(xq[keep], size=SPEC_SIZE).numpy(),
               SPEC_SIZE, SPEC_SIZE // 2)
    got = CV.partitioned_convolve(xb, ir_np, PART)[keep].cpu().numpy()
    cpu = CV.partitioned_convolve(x_cpu, ir_np, PART).numpy()
    err = float(np.abs(got - cpu).max())
    ref = np.stack([scipy.signal.fftconvolve(
        r.astype(np.float64), ir_np.astype(np.float64))[:n]
        for r in x_cpu.numpy()])
    err_ref = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    print(f"[spectral] partitioned_convolve at the bench shape: CUDA vs CPU "
          f"render {err:.3e}, vs scipy.signal.fftconvolve in f64 "
          f"{err_ref:.3e} (max |y| {scale:.1f}; limits "
          f"{AUDIO_EPS} x max(1, max|y|), 2e-5 x max(1, max|y|))")
    check(err <= AUDIO_EPS * max(1.0, float(np.abs(cpu).max())) and
          err_ref <= 2e-5 * max(1.0, scale),
          "partitioned_convolve disagrees with the CPU render or scipy")
    entries["partition_mac"]["conv_vs_scipy_f64"] = err_ref
    del xb
    torch.cuda.empty_cache()
    return [entries[k] for k in ("frame_window", "overlap_add_norm",
                                 "gate_gain", "partition_mac")]


def k9_counts():
    from zorak_tpu_torch.kernels import dsp_scan as DS

    return {name: getattr(DS, c) for name, c in K9_COUNTERS.items()}


def k9_set_counts(counts):
    from zorak_tpu_torch.kernels import dsp_scan as DS

    for name, c in K9_COUNTERS.items():
        setattr(DS, c, counts.get(name, 0))


def k9_phase(torch, cuda, rng, card):
    """K9 on the card: each kernel against its host form (bit for bit,
    every NaN one value) and its plain ladder (within TOL_REL x max|y|,
    NaN and inf in the same places) at the edge shapes, then its time at
    the main length beside its bound and the ladder's.  Returns the
    figures by stage (onepole, integrator, max_follower, biquad_tf2,
    lcg_noise)."""
    from zorak_tpu_torch.kernels import dsp_scan as DS
    from zorak_tpu_torch.models import dspkit as K

    t0 = time.perf_counter()
    DS._host_library()          # the host form, built with g++ once
    tiles_t = DS.TILE_MAPS * DS.CHUNK + 3 * DS.CHUNK + 5
    var_bq = [K.rbj_coeffs(kind, fc, q, SR) for kind, fc, q in
              (("bp_skirt", 9500.0, 1.0), ("hp", 11500.0, 0.707),
               ("bp_skirt", 16000.0, 1.2))]
    fns = {  # stage: (kernel, host form, plain)
        "onepole": (lambda *a: DS.affine_scan(*a, onepole=True),
                    lambda *a: DS.affine_scan_host(*a, onepole=True),
                    lambda *a: DS.affine_scan_plain(*a, onepole=True)),
        "integrator": (lambda *a: DS.affine_scan(*a, onepole=False),
                       lambda *a: DS.affine_scan_host(*a, onepole=False),
                       lambda *a: DS.affine_scan_plain(*a, onepole=False)),
        "max_follower": (DS.maxplus_scan, DS.maxplus_scan_host,
                         DS.maxplus_scan_plain),
        "biquad_tf2": (DS.biquad_scan, DS.biquad_scan_host,
                       DS.biquad_scan_plain),
    }
    errs = {name: 0.0 for name in fns}
    cases = {name: 0 for name in list(fns) + ["lcg_noise"]}

    def cpu(v):
        return v.cpu() if isinstance(v, torch.Tensor) else v

    def held(stage, what, x, *args, places=True):
        kernel, host, plain = fns[stage]
        got = kernel(x, *args)
        want = plain(x, *args)
        torch.cuda.synchronize()
        got = got.cpu()
        want = want.cpu()
        on_host = host(x.cpu(), *(cpu(a) for a in args))
        bits = same_values(got, on_host)
        same = all(torch.equal(f(got), f(want))
                   for f in (torch.isnan, torch.isposinf, torch.isneginf))
        fin = torch.isfinite(want) & torch.isfinite(got)
        scale = want[fin].abs().max().item() if fin.any() else 0.0
        err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
        check(bits and (same or not places) and err <= DS.TOL_REL * scale,
              f"K9 {stage} {what}: against its host form "
              f"{'bit-identical' if bits else 'DIFFERS'}, NaN and inf "
              f"{'where' if same else 'NOT where'} the ladder puts them, "
              f"max_abs_err {err:.3e} of max|y| {scale:.3e}")
        errs[stage] = max(errs[stage], err)
        cases[stage] += 1

    def signal(shape, positive=False):
        x = rng.randn(*shape)
        return torch.from_numpy(np.abs(x) if positive else x).to(cuda)

    for n_t in K9_EDGE_T + (tiles_t,):
        for rows in (1, 3, 8):
            shape = (n_t,) if rows == 1 else (rows, n_t)
            what = f"T={n_t} rows={rows}"
            z0 = (0.3 if rows == 1 else torch.from_numpy(
                rng.uniform(-1.0, 1.0, (rows, 1))).to(cuda))
            x = signal(shape)
            for pole in (0.98, float(np.exp(-1.0 / (SR * 0.14)))):
                held("onepole", f"{what} pole={pole:.6f}", x, pole, z0)
            held("integrator", what, x, 0.95, z0)
            held("max_follower", what, signal(shape, True), 0.97,
                 abs(z0) if rows == 1 else z0.abs())
            for c in var_bq:
                held("biquad_tf2", what, x, *c, (0.1, -0.2))
        pole = torch.from_numpy(0.9 + 0.09 * np.abs(np.sin(
            np.arange(n_t) / 50.0))).to(cuda)
        held("onepole", f"T={n_t} rows=3 per-sample pole", signal((3, n_t)),
             pole, 0.3)
    # NaN and inf in x: no product of these poles underflows at 4,097
    # samples, so the ladder keeps inf; the biquad's ladder gives inf in a
    # few samples after an inf that its sequential loop, and the kernel,
    # give NaN (tests/test_torch_dsp_scan.py holds the host form there to
    # the loop), so there the kernel is held to its host form alone
    for kind in ("nan", "inf", "-inf"):
        for stage in fns:
            x = rng.randn(3, 4097)
            if stage == "max_follower":
                x = np.abs(x)
            if kind == "nan":
                x[0, 1500], x[2, 5] = np.nan, np.nan
            else:
                x[0, 1500] = np.inf
                x[1, 7] = np.inf if kind == "inf" or \
                    stage == "max_follower" else -np.inf
            x = torch.from_numpy(x).to(cuda)
            if stage == "biquad_tf2":
                held(stage, f"{kind} in x", x, *var_bq[0], (0.1, -0.2),
                     places=kind == "nan")
            else:
                held(stage, f"{kind} in x", x, 0.97, 0.3)
    for seed in K9_LCG_SEEDS:
        for n in (1, 255, 256, 257, 4097, 1056 * 256 + 1, MAIN_T):
            got = DS.lcg_noise(n, seed, device=cuda)
            want = DS.lcg_noise_plain(n, seed, device=cuda)
            on_host = DS.lcg_noise_host(n, seed)
            check(same_bits(got, want) and same_bits(got.cpu(), on_host),
                  f"K9 lcg_noise n={n} seed={seed} differs from its plain "
                  f"version or its host form")
            cases["lcg_noise"] += 1
    print(f"[kernels] K9 edge shapes: {json.dumps(cases)} cases, each "
          f"bit-identical to its host form; max_abs_err against the "
          f"ladders {json.dumps(errs)}; {time.perf_counter() - t0:.1f} s")

    # the main length, one row, f64: each kernel's device time (a CUDA
    # graph of 20 calls: a call's host work exceeds its kernels'), the
    # wrapper's eager time, the ladder's
    xs = torch.from_numpy(rng.randn(MAIN_T)).to(cuda)
    xa = xs.abs()
    bq = K.rbj_coeffs("hp", 11500.0, 0.707, SR)
    mains = {
        "onepole": (lambda: DS.affine_scan(xs, 0.99, onepole=True),
                    lambda: DS.affine_scan_plain(xs, 0.99, onepole=True)),
        "integrator": (lambda: DS.affine_scan(xs, 0.95, onepole=False),
                       lambda: DS.affine_scan_plain(xs, 0.95,
                                                    onepole=False)),
        "max_follower": (lambda: DS.maxplus_scan(xa, 0.97),
                         lambda: DS.maxplus_scan_plain(xa, 0.97)),
        "biquad_tf2": (lambda: DS.biquad_scan(xs, *bq),
                       lambda: DS.biquad_scan_plain(xs, *bq)),
        "lcg_noise": (lambda: DS.lcg_noise(MAIN_T, device=cuda),
                      lambda: DS.lcg_noise_plain(MAIN_T, device=cuda)),
    }
    out = {}
    for stage, (fn, plain) in mains.items():
        got, want = fn(), plain()
        err = (got - want).abs().max().item()
        if stage == "lcg_noise":
            check(same_bits(got, want), "K9 lcg_noise at the main length "
                  "differs from its plain version")
        else:
            check(err <= DS.TOL_REL * want.abs().max().item(),
                  f"K9 {stage} at the main length: max_abs_err {err:.3e}")
        ms = graph_ms(fn)
        eager_ms = cuda_ms(fn, reps=20)
        plain_ms = cuda_ms(plain, reps=3)
        ms_2 = graph_ms(fn)
        nbytes = (1 if stage == "lcg_noise" else 2) * MAIN_T * 8
        # the noise's 32-bit integer steps at the 32-bit non-tensor rate
        bound, by = bound_ms(nbytes, K9_OPS[stage] * MAIN_T,
                             "float32" if stage == "lcg_noise" else "float64")
        out[stage] = {"ms": ms, "ms_again": ms_2, "eager_ms": eager_ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "max_abs_err": max(err, errs.get(
                          stage, 0.0)), "cases": cases[stage]}
        print(f"[kernels] K9 {stage} float64 T={MAIN_T}: ms={ms:.5f} (again "
              f"{ms_2:.5f}, a CUDA graph of 20 calls) eager_ms="
              f"{eager_ms:.5f} plain_ms={plain_ms:.3f} bound_ms={bound:.5f} "
              f"({by}) {ms / bound:.2f}x the bound max_abs_err={err:.3e} "
              f"card='{card}'")
    return out


def faust_phases(torch, cuda, rng, card):
    """The Faust family: K1 against its plain loop, K9 against its host
    form and its plain ladders, the VAR renders and the batch renders;
    returns K1's and K9's entries of the `kernels` line."""
    from zorak_tpu_torch.kernels import switching_scan as SS
    from zorak_tpu_torch.models import FAUST_MODULES, dspkit as K
    from zorak_tpu_torch.models import get_faust_module
    from zorak_tpu_torch.models.faust_golden import GOLDENS
    from zorak_tpu_torch.parallel import FaustBatchRenderer
    from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio

    def zero_reruns():
        for v in SS.RERUN_STEPS.values():
            v.zero_()

    def rerun_steps():
        return sum(int(v.item()) for v in SS.RERUN_STEPS.values())

    # 5. K1 against its plain version -----------------------------------
    # K1 must equal its plain loop bit for bit (same_bits: integer views)
    def scan_inputs(n_t, lanes, dtype, up=None, dn=None, x=None, rng=rng):
        x = np.abs(rng.randn(n_t, lanes)) if x is None else x
        x = torch.from_numpy(x).to(cuda, dtype)
        upv = torch.from_numpy(rng.uniform(0.3, 0.9, lanes) if up is None
                               else np.full(lanes, up)).to(cuda, dtype)
        dnv = torch.from_numpy(rng.uniform(0.95, 0.9999, lanes) if dn is None
                               else np.full(lanes, dn)).to(cuda, dtype)
        z0 = torch.from_numpy(rng.uniform(0.0, 1.0, lanes)).to(cuda, dtype)
        return x, upv, dnv, z0

    def adversarial(kind, n_t, lanes):
        x = np.abs(rng.randn(n_t, lanes))
        if kind == "silence":       # a burst, then exact zeros: never merges
            x[n_t // 10:] = 0.0
        elif kind == "constant":
            x[:] = 0.25
        elif kind == "negzero":
            x[::3] = -0.0
        elif kind == "nan":
            x[n_t // 2] = np.nan
        return x

    def witnessed(what, args):
        """K1 at its defaults against K1 as one chunk on the same inputs,
        bit for bit; returns the defaults' re-run steps."""
        zero_reruns()
        got = SS.switching_scan(*args)
        reruns = rerun_steps()
        ok = same_bits(got, SS.switching_scan(*args, chunk=args[0].shape[0]))
        print(f"[kernels] switching_scan {what} T={args[0].shape[0]} "
              f"lanes={args[0].shape[1]} {str(args[0].dtype)[6:]} defaults vs "
              f"one chunk: {'bit-identical' if ok else 'DIFFERS'} "
              f"rerun_steps={reruns}")
        check(ok, f"switching_scan {what} differs from its one-chunk case")
        return reruns

    def caught_scans(fn):
        """Runs fn() and returns the arguments of every K1 call it made."""
        caught, plain = [], SS.switching_scan

        def spy(*a, **kw):
            caught.append(a)
            return plain(*a, **kw)

        SS.switching_scan = spy
        try:
            fn()
        finally:
            SS.switching_scan = plain
        return caught

    def held(what, args, ref=None, **kw):
        """K1 against the plain loop on the same CUDA inputs, bit for bit;
        returns (plain result, re-run steps)."""
        zero_reruns()
        got = SS.switching_scan(*args, **kw)
        reruns = rerun_steps()
        if ref is None:
            ref = SS.switching_scan_reference(*args)
        torch.cuda.synchronize()
        ok = same_bits(got, ref)
        print(f"[kernels] switching_scan {what} {dict(kw) or 'defaults'}: "
              f"{'bit-identical' if ok else 'DIFFERS'} rerun_steps={reruns}")
        check(ok, f"switching_scan {what} {kw} differs from its plain loop")
        return ref, reruns

    small = {"chunk": 64, "warmup": 64}
    # VAR's follower poles: 2.5 ms attack, 80 ms release
    VAR_POLES = (float(np.exp(-1.0 / (SR * 0.0025))),
                 float(np.exp(-1.0 / (SR * 0.080))))
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for n_t, lanes in ((8192, 1), (8191, 3), (8192, 128),
                           (BATCH_T, BATCH_FILES)):
            held(f"{dname} T={n_t} lanes={lanes}",
                 scan_inputs(n_t, lanes, dtype))
        # many chunks and re-runs at small T
        for n_t in (1, 63, 64, 65, 4095, 20_000):
            for lanes in (1, 3, 8):
                held(f"{dname} T={n_t} lanes={lanes}",
                     scan_inputs(n_t, lanes, dtype), **small)
        for kind in ("silence", "constant", "negzero", "nan"):
            args = scan_inputs(20_000, 3, dtype, x=adversarial(kind, 20_000, 3))
            ref, _ = held(f"{dname} {kind} T=20000 lanes=3", args, **small)
            held(f"{dname} {kind} T=20000 lanes=3", args, ref)
        # past warm-up + chunk at the defaults: chunks after the burst are
        # speculated and, decaying at VAR's release pole, never merge
        n_long = 60_000
        args = scan_inputs(n_long, 3, dtype, *VAR_POLES,
                           x=adversarial("silence", n_long, 3))
        _, reruns = held(f"{dname} silence T={n_long} lanes=3", args)
        check(reruns > 0, "the default-settings silence case re-ran nothing")

    # VAR's follower, one lane, at VAR's poles: K1 at its defaults and as
    # one chunk (a thread per lane) against the plain loop, bit for bit.
    # The plain Python loop takes 70 to 110 us a step, minutes at the main
    # length, so both dtypes run K1_PLAIN_T steps of it, and at the main
    # length K1 at its defaults is held to K1 as one chunk.
    one = {"chunk": MAIN_T}         # one chunk: a thread per lane
    # a stream of its own: the draws below stay what they were before the
    # f32 plain loop was cut
    rng_plain = np.random.RandomState(SEED + 7)
    args = scan_inputs(K1_PLAIN_T, 1, torch.float32, *VAR_POLES, rng=rng_plain)
    t0 = time.perf_counter()
    ref, _ = held(f"float32 T={K1_PLAIN_T} lanes=1", args)
    held(f"float32 T={K1_PLAIN_T} lanes=1", args, ref, **one)
    print(f"[kernels] switching_scan plain loop float32 T={K1_PLAIN_T}: "
          f"{time.perf_counter() - t0:.1f} s")
    witnessed("main shape", scan_inputs(MAIN_T, 1, torch.float32, *VAR_POLES))
    args = scan_inputs(MAIN_T, 1, torch.float64, *VAR_POLES)
    short = (args[0][:K1_PLAIN_T],) + tuple(args[1:])   # x is [T, lanes]
    ref_holder = []
    t0 = time.perf_counter()
    plain_ms = cuda_ms(lambda: ref_holder.append(
        SS.switching_scan_reference(*short)))
    ref = ref_holder[0]
    print(f"[kernels] switching_scan plain loop float64 T={K1_PLAIN_T}: "
          f"{time.perf_counter() - t0:.1f} s")
    held(f"float64 T={K1_PLAIN_T} lanes=1", short, ref)
    held(f"float64 T={K1_PLAIN_T} lanes=1", short, ref, **one)
    scan_err = (SS.switching_scan(*short) - ref).abs().max().item()
    ref = SS.switching_scan(*args, **one)     # the main length: one chunk
    _, main_reruns = held(f"float64 T={MAIN_T} lanes=1", args, ref)
    # the new default, the one-chunk design, the default again: same card
    scan_ms = cuda_ms(lambda: SS.switching_scan(*args), reps=5)
    earlier_ms = cuda_ms(lambda: SS.switching_scan(*args, **one), reps=3)
    scan_ms_2 = cuda_ms(lambda: SS.switching_scan(*args), reps=5)
    bound_ms, bound_by = scan_bound_ms(MAIN_T, 1, "float64")
    chunk, warmup, n_chunks = SS.chunk_plan(MAIN_T, SS.CHUNK,
                                            SS.WARMUP[torch.float64])
    print(f"[kernels] switching_scan float64 T={MAIN_T} lanes=1 bit-identical "
          f"max_abs_err={scan_err:.3e} ms={scan_ms:.4f} "
          f"(again {scan_ms_2:.4f}) "
          f"one_chunk_ms={earlier_ms:.4f} plain_ms={plain_ms:.1f} "
          f"bound_ms={bound_ms:.5f} ({bound_by}) chunk={chunk} "
          f"warmup={warmup} chunks={n_chunks} rerun_steps={main_reruns}")

    # the worst case: a burst, then silence to the end; no chunk after the
    # burst merges, so the fix-up re-runs them all one after another
    worst = scan_inputs(MAIN_T, 1, torch.float64, *VAR_POLES,
                        x=adversarial("silence", MAIN_T, 1))
    worst_reruns = witnessed("worst case (burst then silence)", worst)
    worst_ms = cuda_ms(lambda: SS.switching_scan(*worst), reps=2)
    print(f"[kernels] switching_scan float64 T={MAIN_T} worst case (burst "
          f"then silence): ms={worst_ms:.4f} rerun_steps={worst_reruns}")

    # the chain bound: the same dependent steps in one thread, x cycling
    # through registers, no memory traffic (checked against the plain loop
    # on the same repeated x first)
    xc, chain_args = args[0][:SS.CHAIN_CHUNK, 0].contiguous(), args[1:]
    n_check = 128 * SS.CHAIN_CHUNK
    z_ref = SS.switching_scan_reference(
        xc.repeat(n_check // SS.CHAIN_CHUNK)[:, None], *chain_args)[-1]
    check(same_bits(SS.switching_chain_probe(xc, *chain_args, n_check), z_ref),
          "chain probe differs from the plain loop")
    SS.switching_chain_probe(xc, *chain_args, MAIN_T)
    chain_ms = cuda_ms(
        lambda: SS.switching_chain_probe(xc, *chain_args, MAIN_T), reps=3)
    chain_ns = chain_ms * 1e6 / MAIN_T
    chunk_chain_ms = (warmup + chunk) * chain_ns * 1e-6
    print(f"[kernels] switching_scan chain bound, float64 T={MAIN_T}: "
          f"chain_ms={chain_ms:.4f} ns_per_step={chain_ns:.3f}; one chunk "
          f"{earlier_ms / chain_ms:.3f}x it; chunked bound (warmup + chunk) "
          f"x {chain_ns:.3f} ns = {chunk_chain_ms:.4f} ms, the kernel "
          f"{scan_ms / chunk_chain_ms:.3f}x it")

    # K9 against its host form and its plain ladders; a stream of its own,
    # so the draws below stay what they were before K9
    k9 = k9_phase(torch, cuda, np.random.RandomState(SEED + 18), card)

    # stage times at the main shape, each after a warm-up, for the
    # breakdown of a VAR render: the calls as a render makes them
    xs = torch.from_numpy(rng.randn(MAIN_T)).to(cuda, torch.float64)
    xa = xs.abs()
    bq = K.rbj_coeffs("hp", 11500.0, 0.707, SR)
    stage_fns = {
        "lcg_noise": lambda: K.lcg_noise(MAIN_T, device=cuda),
        "biquad_tf2": lambda: K.biquad_tf2(xs, *bq),
        "onepole": lambda: K.onepole(xs, 0.99),
        "integrator": lambda: K.integrator(xs, 0.95),
        "max_follower": lambda: K.max_follower(xa, 0.97),
    }
    stages = {}
    for name, fn in stage_fns.items():
        fn()
        stages[name] = cuda_ms(fn, 20)
    stages["switching_scan"] = scan_ms
    print("[stages] T=%d f64 %s" % (MAIN_T, " ".join(
        f"{k}_ms={v:.3f}" for k, v in stages.items())))

    # 6. main path: VAR, 60 s of 48 kHz stereo -------------------------------
    var = get_faust_module("VAR")
    v = var.values()
    x_np = rng.randn(2, MAIN_T) * 0.25
    x = torch.from_numpy(x_np).to(cuda)
    var_scans = caught_scans(lambda: var(x, v, SR))   # warm-up
    torch.cuda.synchronize()
    SS.LAUNCHES = 0
    k9_set_counts({})
    zero_reruns()
    t0 = time.perf_counter()
    y_holder = []
    var_ms = cuda_ms(lambda: y_holder.append(var(x, v, SR)))
    var_wall = time.perf_counter() - t0
    main_launches = {"switching_scan": SS.LAUNCHES, **k9_counts()}
    var_reruns = rerun_steps()
    y = y_holder[0]
    check(main_launches == {"switching_scan": 1, **VAR_K9_LAUNCHES},
          f"a VAR render launched {main_launches}, not K1 once and "
          f"{VAR_K9_LAUNCHES}")
    check(tuple(y.shape) == (2, MAIN_T), f"VAR output shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "VAR output not finite")
    sec = MAIN_T / SR
    print(f"[main] VAR 60 s stereo: device_ms={var_ms:.2f} wall_s={var_wall:.4f} "
          f"audio_s_per_s={sec / (var_ms / 1e3):.1f} launches={main_launches} "
          f"rerun_steps={var_reruns} card='{card}'")
    staged_ms = sum(n * stages[k] for k, n in VAR_STAGES.items())
    print(f"[main] VAR stages {VAR_STAGES} account for {staged_ms:.2f} ms "
          f"of {var_ms:.2f} ms")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[main] SM clock after the render, current and max: {clocks}")
    profile_render(lambda: var(x, v, SR), "VAR")

    n1 = int(SR)
    y_cpu = var(torch.from_numpy(x_np[:, :n1]), v, SR)
    rep = compare_audio(y_cpu.to(torch.float32).numpy(),
                        y[:, :n1].to(torch.float32).cpu().numpy())
    print(f"[main] first 1 s, CUDA vs CPU render: {rep.summary()}")
    check(rep.audio_passed, f"CUDA render disagrees with CPU at {AUDIO_EPS}")
    for a in var_scans:
        witnessed("VAR follower input", a)

    # the same render on program-like material: a 2 s silent lead-in,
    # 1 s silent gaps at 10, 20, 30 and 40 s, a 5 s fade-out to silence.
    # In silence VAR's detector decays at its release pole and a guess
    # does not merge, so the fix-up re-runs there.
    s1 = int(SR)
    x_prog = rng.randn(2, MAIN_T) * 0.25
    x_prog[:, :2 * s1] = 0.0
    for a in range(10 * s1, 50 * s1, 10 * s1):
        x_prog[:, a:a + s1] = 0.0
    x_prog[:, -5 * s1:] *= np.linspace(1.0, 0.0, 5 * s1)
    x_prog = torch.from_numpy(x_prog).to(cuda)
    prog_scans = caught_scans(lambda: var(x_prog, v, SR))   # warm-up
    SS.LAUNCHES = 0
    k9_set_counts({})
    zero_reruns()
    prog_ms = cuda_ms(lambda: var(x_prog, v, SR))
    prog_reruns, prog_launches = rerun_steps(), SS.LAUNCHES
    print(f"[main] VAR 60 s stereo, program-like material: device_ms="
          f"{prog_ms:.2f} audio_s_per_s={sec / (prog_ms / 1e3):.1f} "
          f"launches={prog_launches} rerun_steps={prog_reruns} (share "
          f"{prog_reruns / MAIN_T:.4f} of T) card='{card}'")
    for a in prog_scans:
        witnessed("VAR follower input, program-like", a)

    # 7. batch path: five modules, 8 files x 10 s ----------------------------
    batch = {}
    batch_k9 = dict.fromkeys(K9_COUNTERS, 0)
    for slug in FAUST_MODULES:
        r = FaustBatchRenderer(slug, srate=SR, device=cuda)
        xb = (rng.randn(BATCH_FILES, r.nch, BATCH_T) * 0.25).astype(np.float32)
        xb = torch.from_numpy(xb).to(cuda)
        scans = caught_scans(lambda: r.render_files(xb))   # warm-up
        SS.LAUNCHES = 0
        k9_set_counts({})
        zero_reruns()
        out = []
        ms = cuda_ms(lambda: out.append(r.render_files(xb)))
        reruns = rerun_steps()
        k9_launches = k9_counts()
        for name, n in k9_launches.items():
            batch_k9[name] += n
        yb = out[0]
        check(tuple(yb.shape) == tuple(xb.shape), f"{slug} batch shape")
        check(bool(torch.isfinite(yb).all()), f"{slug} batch not finite")
        check(SS.LAUNCHES > 0 or slug not in ("VAR", "RED"),
              f"{slug} batch skipped the switching scan")
        audio_s = BATCH_FILES * BATCH_T / SR
        batch[slug] = audio_s / (ms / 1e3)
        print(f"[batch] {slug} {BATCH_FILES}x{r.nch}ch x 10 s: device_ms={ms:.2f} "
              f"audio_s_per_s={batch[slug]:.1f} switching_scan_launches="
              f"{SS.LAUNCHES} k9_launches={json.dumps(k9_launches)} "
              f"rerun_steps={reruns} card='{card}'")
        if slug == "VAR":
            # VAR runs no conv1d (whose algorithm may change with the
            # batch): every file equals its solo render bit for bit
            solo = r.raw_render(BATCH_T)
            for i in range(BATCH_FILES):
                check(torch.equal(solo(xb[i])[0], yb[i]),
                      f"VAR batch file {i} differs from its solo render")
            print(f"[batch] VAR: each of the {BATCH_FILES} files torch.equal "
                  f"to its solo render")
        for a in scans:
            witnessed(f"{slug} batch follower input", a)
        # every module is causal: the first second of each file against
        # the same module's CPU render of that second
        y_cpu = FaustBatchRenderer(slug, srate=SR, device="cpu").render_files(
            xb[:, :, :n1].cpu())
        rep = compare_audio(y_cpu.reshape(-1, n1).numpy(),
                            yb[:, :, :n1].reshape(-1, n1).cpu().numpy())
        print(f"[batch] {slug} first 1 s, CUDA vs CPU render: {rep.summary()}")
        check(rep.audio_passed,
              f"{slug} batch render disagrees with CPU at {AUDIO_EPS}")
        # and the module's NumPy golden (models/faust_golden.py) on the
        # first FAUST_GOLDEN_T samples of file 0
        x0 = xb[0, :, :FAUST_GOLDEN_T].cpu().double().numpy()
        rep = compare_audio(GOLDENS[slug](x0, r.values, SR),
                            yb[0, :, :FAUST_GOLDEN_T].cpu().numpy())
        print(f"[batch] {slug} file 0, first {FAUST_GOLDEN_T} samples, "
              f"CUDA vs the NumPy golden: {rep.summary()}")
        check(rep.audio_passed,
              f"{slug} batch render disagrees with its golden at {AUDIO_EPS}")

    check(all(main_launches[n] + batch_k9[n] > 0 for n in K9_COUNTERS),
          f"the Faust paths skipped a K9 kernel: VAR {main_launches}, "
          f"batch {batch_k9}")
    k9_entries = []
    for name, stage, src_line in (
            ("affine_scan", "onepole", 52), ("maxplus_scan", "max_follower",
                                             78),
            ("biquad_scan", "biquad_tf2", 138), ("lcg_noise", "lcg_noise",
                                                 244)):
        f = k9[stage]
        entry = {
            "name": name, "route": "cuda",
            "source": "zorak_tpu_torch/csrc/dsp_scan.cu",
            "replaces": f"zorak_tpu/models/dspkit.py:{src_line}",
            "launches": main_launches[name] + batch_k9[name],
            "launches_var": main_launches[name],
            "launches_batch": batch_k9[name],
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None,
            "stage": stage, "ms_again": f["ms_again"],
            "eager_ms": f["eager_ms"], "edge_cases": f["cases"]}
        if name == "affine_scan":    # K9a's other stage
            entry.update({f"integrator_{k}": v
                          for k, v in k9["integrator"].items()})
        k9_entries.append(entry)

    return [{
        "name": "switching_scan",
        "route": "cuda",
        "source": "zorak_tpu_torch/csrc/switching_scan.cu",
        "replaces": "zorak_tpu/kernels/pallas_scan.py:52",
        "launches": main_launches["switching_scan"],
        "max_abs_err": scan_err,
        "ms": scan_ms,
        "plain_ms": plain_ms,
        "plain_T": K1_PLAIN_T,     # the plain loop's length, in f64
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "chain_ms": chain_ms,
        "chunk_chain_ms": chunk_chain_ms,
        "earlier_ms": earlier_ms,
        "worst_ms": worst_ms,
        "rerun_steps": var_reruns,
        "worst_rerun_steps": worst_reruns,
        "program_rerun_steps": prog_reruns,
        "chunk": chunk,
        "warmup": warmup,
        "library_ms": None,
    }] + k9_entries


TOOLING_BENCH_S = 10.0     # bench --seconds on the card


def tooling_phase(torch, cuda, card):
    """Slice 7's tooling on the card, as a user calls it: the CLI's
    new-plugin into a temporary catalog (in the checkout's build folder),
    the gmem stand-in and grain_texture written there as leaves, help
    (--plain) on every entry, bench --seconds 10 --json on one vector
    entry (the scaffold) and one sequential-executor entry (the stand-in),
    then utils.dumps.dump_stages of a vector kernel with a scan group
    (K4), a coupled one (K10) and a devexec one (K11), nvcc's register and
    spill lines printed."""
    import contextlib
    import io
    import shutil
    import tempfile

    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.cli.main import main as cli
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build
    from zorak_tpu_torch.runtime.engine import PluginInstance
    from zorak_tpu_torch.utils.dumps import dump_stages

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        return rc, buf.getvalue()

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="tooling-", dir=_build.BUILD_DIR))
    try:
        rc, out = run(["new-plugin", "--catalog", str(root), "--category",
                       "Bench", "--key", "Gain", "--name", "Gain"])
        check(rc == 0 and "scaffolded" in out, f"new-plugin: rc {rc} {out}")
        for cat, slug, src in (
                ("Bench", "Pan", BP.scene_voice_panner(*DEVEXEC_PANNER)),
                ("Texture", "Grain", BP.grain_texture(DEVEXEC_GRAINS,
                                                      DEVEXEC_RING))):
            leaf = root / "plugins" / cat / slug
            (leaf / "src").mkdir(parents=True)
            (leaf / "plugin.json").write_text(json.dumps({
                "name": slug, "slug": slug, "pluginCode": f"Z{slug[:3]}",
                "pluginType": "jsfx"}))
            (leaf / "README.md").write_text(f"# {slug}\n\nThe {slug} "
                                            "stand-in.\n")
            (leaf / "src" / f"{slug}.jsfx").write_text(src)
        rc, out = run(["help", "--catalog", str(root), "--plain"])
        check(rc == 0 and out.count("Controls") == 1 and "Gain\n====" in out
              and "The Pan stand-in." in out and "slider1" in out,
              f"help: rc {rc}, {len(out)} characters")
        print(f"[tooling] new-plugin scaffolded Bench/Gain; help --plain on "
              f"3 entries: {len(out.splitlines())} lines, the scaffold's "
              f"Controls reference included")
        t0 = time.perf_counter()
        rc, out = run(["bench", "--catalog", str(root), "--only", "Bench",
                       "--seconds", str(TOOLING_BENCH_S), "--json"])
        wall = time.perf_counter() - t0
        lines = out.strip().splitlines()
        got = json.loads(lines[-1]) if lines else {}
        for ln in lines:
            print(f"[tooling] bench: {ln}")
        check(rc == 0 and set(got) == {"Gain", "Pan"}
              and min(got.values()) > 0,
              f"bench: rc {rc}, {out}")
        print(f"[tooling] bench --seconds {TOOLING_BENCH_S:.0f} --json on the "
              f"card (best of 3, synchronised): Gain (torch-vector) "
              f"{got['Gain']}x, Pan (torch-devexec) {got['Pan']}x realtime; "
              f"{wall:.1f} s with the builds and warm-ups card='{card}'")
        kernels = {
            "vector": PluginInstance(compile_plugin_source(SCAN_GROUP_SRC),
                                     srate=SR),
            "coupled": PluginInstance(compile_plugin_source(
                BP.spectral_tilt_leveler(COUPLED_FFT)), srate=SR),
            "devexec": PluginInstance(compile_plugin_source(
                BP.scene_voice_panner(*DEVEXEC_PANNER)), srate=SR),
        }
        for label, inst in kernels.items():
            t0 = time.perf_counter()
            paths = dump_stages(inst.kernel, root / "dumps" / label)
            build = Path(paths["06_build.txt"]).read_text()
            cu = Path(paths["05_cuda.cu"]).read_text()
            heads = [ln for ln in cu.splitlines() if ln.startswith("// ====")]
            ptxas = [ln for ln in build.splitlines()
                     if "registers" in ln or "spill" in ln]
            check(len(paths) == 6 and inst.engine != "cpu-shadow" and heads
                  and build.count("nvcc exit 0") == len(heads) and ptxas,
                  f"dumps of the {label} kernel: {build[:400]}")
            print(f"[tooling] dump_stages, {label} kernel ({inst.engine}): "
                  f"{len(paths)} files in {time.perf_counter() - t0:.1f} s; "
                  f"05 holds {heads or 'no generated source'}; "
                  + Path(paths["04_ops.txt"]).read_text().splitlines()[0])
            for ln in build.splitlines():
                print(f"[tooling] 06_build.txt ({label}): {ln}")
        return {"bench_rtx": got}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sampler_host(seed: int = SEED):
    """An EngineHost whose file slot 0 holds the sampler's entries, made
    from the seed (builtin_plugins.sampler_slot)."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.runtime.services import EngineHost

    host = EngineHost()
    for audio, rate in BP.sampler_slot(SERVICES_SAMPLES, SERVICES_SAMPLE_S,
                                       seed=seed):
        host.files.load_slot(0, audio, srate=rate)
    return host


def table_host(seed: int = SEED):
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.runtime.services import EngineHost

    host = EngineHost()
    host.files.load_slot(0, BP.table_slot(SERVICES_TABLE, seed=seed),
                         srate=SR)
    return host


def sampler_input():
    """The sampler's 60 s of stereo input, from the seed."""
    rng = np.random.RandomState(SEED + 15)
    return (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)


def sampler_golden_child(out: str) -> int:
    """The sampler's 60 s native golden (its pool read through the
    EngineHost, a Python call a read: minutes on one core), in a process
    of its own beside the other phases: audio, vars and heap to `out`."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build
    from zorak_tpu_torch.shadow import compile_native_shadow
    from zorak_tpu_torch.verify import apply_slider_state

    os.environ.setdefault("ZORAK_TPU_CACHE", str(_build.BUILD_DIR))
    prog = compile_plugin_source(BP.pool_sampler(SERVICES_VOICES,
                                                 SERVICES_SAMPLES))
    x = sampler_input()
    gold = compile_native_shadow(prog, host=sampler_host())
    gold.state.srate = SR
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y = np.zeros_like(x)
    t0 = time.perf_counter()
    for start in range(0, MAIN_T, 512):
        gold.process_block(x[:, start:start + 512], y[:, start:start + 512])
    secs = time.perf_counter() - t0
    names = sorted(gold.state.V)
    np.savez(out, y=y, mem=np.asarray(gold.state.mem[:gold.state.mem_used]),
             names=np.asarray(names),
             values=np.asarray([gold.state.V[k] for k in names]),
             spl=np.asarray(gold.state.spl), secs=secs, ended=time.time())
    return 0


def start_sampler_golden():
    """The sampler's golden in a child process: (process, output path,
    its start on the wall clock)."""
    from zorak_tpu_torch.kernels import _build

    out = Path(_build.BUILD_DIR) / f"sampler_golden_{os.getpid()}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    # at a lower priority: the host-paced phases keep their cores
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--sampler-golden", str(out)],
                            cwd=str(Path(__file__).resolve().parent),
                            preexec_fn=lambda: os.nice(10))
    return proc, out, time.time()


def sampler_golden_held(prog, y, state, golden, t_start):
    """The 60 s render against the child's golden: audio 1e-5, vars and
    heap 1e-8 (`compare_states`, `compare_memory_pages`); (report, the
    golden's host seconds).  Prints the child's span in the script's
    seconds (from `t_start`, a perf_counter), beside which the phases'
    ends say which of them it overlapped."""
    from zorak_tpu_torch.verify import compare_audio
    from zorak_tpu_torch.verify.nulltest import (compare_memory_pages,
                                                 compare_states,
                                                 make_initialized_shadow)

    proc, path, started = golden
    t0 = time.perf_counter()
    rc = proc.wait(timeout=1500)
    print(f"[services] waited {time.perf_counter() - t0:.1f} s for the "
          f"sampler's golden (rc {rc})")
    check(rc == 0, "services: the sampler's golden process failed")
    with np.load(path) as g:
        y_gold, mem, names, values = g["y"], g["mem"], g["names"], g["values"]
        spl, secs, ended = g["spl"], float(g["secs"]), float(g["ended"])
    now = time.perf_counter() - t_start
    print(f"[services] the sampler's golden child ran from "
          f"{now - (time.time() - started):.1f} s to "
          f"{now - (time.time() - ended):.1f} s of the script")
    path.unlink()
    gold = make_initialized_shadow(prog, SR).state
    gold.V = {str(k): float(v) for k, v in zip(names, values)}
    gold.mem = mem.copy()
    gold.mem_used = len(mem)
    gold.spl = [float(v) for v in spl]
    rep = compare_audio(y_gold, y)
    compare_states(gold, state, report=rep)
    compare_memory_pages(gold, state, report=rep)
    return rep, secs


def services_phase(torch, cuda, rng, card, golden, t_start):
    """The host services on the card: builtin_plugins.pool_sampler(8, 16)
    over 61.4 MB of pool data through PluginInstance.render on K11 and
    slot_table_leveler(65536) on K10, each 60 s of stereo, held to the
    native golden; K11 and K10 bit for bit to their plain versions; 8
    files against their solo renders with one staging of the tables.
    Returns (K11's fields, K10's fields)."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build
    from zorak_tpu_torch.kernels import block_section as BS
    from zorak_tpu_torch.kernels import device_exec as DX
    from zorak_tpu_torch.runtime.engine import PluginInstance
    from zorak_tpu_torch.verify import AUDIO_EPS, SCALAR_EPS

    sec = MAIN_T / SR
    # 1. the instances (the pool's generation built by @init on the host),
    # then K11 and K10 built together
    t0 = time.perf_counter()
    sprog = compile_plugin_source(BP.pool_sampler(SERVICES_VOICES,
                                                  SERVICES_SAMPLES))
    sampler = PluginInstance(sprog, srate=SR, host=sampler_host(),
                             smart_idle="always_awake")
    skern = sampler.kernel
    check(sampler.engine == "torch-devexec" and skern.device.type == "cuda",
          f"services: the sampler's engine {sampler.engine} "
          f"({sampler.spec_error})")
    gen = sampler.shadow.state.host.pool.generation
    pool_bytes = sum(e.data.nbytes for e in gen.entries.values())
    frames = sorted({e.data.shape[0] for e in gen.entries.values()})
    lprog = compile_plugin_source(BP.slot_table_leveler(SERVICES_TABLE))
    leveler = PluginInstance(lprog, srate=SR, host=table_host(),
                             smart_idle="always_awake")
    lkern = leveler.kernel
    check(leveler.engine == "torch-vector" and lkern.coupled
          and lkern._block_prog.tabled,
          f"services: the leveler's engine {leveler.engine} "
          f"({leveler.spec_error})")
    k10 = lkern._block_prog
    print(f"[services] instances in {time.perf_counter() - t0:.2f} s: the "
          f"sampler's pool {len(gen.entries)} entries of {frames} frames, "
          f"{pool_bytes / 1e6:.1f} MB of f32; the leveler's file table "
          f"{k10.tables.file_cells} cells")
    t0 = time.perf_counter()
    logs = _build.build_generated([skern.program.source, k10.source])
    print(f"[services] K11 and K10 built in "
          f"{time.perf_counter() - t0:.2f} s of nvcc, all together")
    for line in logs[skern.program.source].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[services] K11 build: {line.strip()}")

    # 2. the sampler's 60 s render, the main path: counts zeroed before
    x = sampler_input()
    real, launch_ev = DX.device_exec, []

    def timed(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = real(*a, **k)
        ev[1].record()
        launch_ev.append(ev)
        return got

    DX.LAUNCHES = 0
    out = []
    DX.device_exec = timed
    t0 = time.perf_counter()
    try:
        ms = cuda_ms(lambda: out.append(sampler.render(x)))
    finally:
        DX.device_exec = real
    wall = time.perf_counter() - t0
    launches = DX.LAUNCHES
    k_ms = launch_ev[-1][0].elapsed_time(launch_ev[-1][1])
    res = out[0]
    y = res.audio
    check(res.engine == "torch-devexec" and launches == 1
          and not skern.heap_climbs,
          f"services: sampler {res.engine}, {launches} K11 launches, climbs "
          f"{skern.heap_climbs}")
    check(y.shape == (2, MAIN_T) and bool(np.isfinite(y).all()),
          "services: the sampler's output not finite or of the wrong shape")
    check(skern.tables.stagings == 1, f"services: the tables staged "
          f"{skern.tables.stagings} times")
    trig = sampler.shadow.state.V["trig"]
    check(trig >= SERVICES_VOICES + SERVICES_SAMPLES,
          f"services: {trig} triggers, not every entry read")
    print(f"[services] pool_sampler({SERVICES_VOICES}, {SERVICES_SAMPLES}) "
          f"60 s stereo: engine={res.engine} device_ms={ms:.2f} "
          f"wall_s={wall:.4f} K11 {k_ms:.2f} ms (1 launch) "
          f"audio_s_per_s={sec / (k_ms / 1e3):.3f}; {int(trig)} voice "
          f"triggers; tables staged {skern.tables.stagings} time(s) "
          f"card='{card}'")

    # 3. K11 bit for bit to its plain version at the first and the middle
    # block (the plain version answers the pool through the EngineHost)
    mid = (MAIN_T // 512 // 2) * 512
    bv0, bm0 = skern.initial_carry()
    _y_half, (bv_mid, bm_mid) = skern.render_device(x[:, :mid])
    errs, plain_ms = [], None
    for label, (bv, bm), at in (("first", (bv0, bm0), 0),
                                ("middle", (bv_mid, bm_mid), mid)):
        xb = torch.from_numpy(x[None, :, at:at + 512].copy())
        bv, bm = bv[None].contiguous().clone(), bm[None].contiguous().clone()
        bv_c, bm_c = bv.cpu(), bm.cpu()
        saved = DX.LAUNCHES
        y_k, _mo = DX.device_exec(skern.program, xb.to(cuda), bv, bm)
        DX.LAUNCHES = saved           # a comparison, not the main path
        t_p = time.perf_counter()
        y_p, _mo = DX.device_exec(skern.program, xb, bv_c, bm_c)
        if plain_ms is None:
            plain_ms = (time.perf_counter() - t_p) * 1e3
        ok = (same_values(y_k.cpu(), y_p) and same_values(bv.cpu(), bv_c)
              and same_values(bm.cpu(), bm_c))
        err = max(float((y_k.cpu() - y_p).abs().max()),
                  float((bv.cpu() - bv_c).abs().nan_to_num().max()),
                  float((bm.cpu() - bm_c).abs().nan_to_num().max()))
        errs.append(err)
        print(f"[services] K11 vs its plain version at the {label} block "
              f"(sample {at}): {'bit-identical' if ok else 'DIFFERS'} "
              f"(audio, vars, heap; max {err:.3e})")
        check(ok, f"services: K11 at the {label} block differs from its "
              "plain version")

    # 4. 8 files x 10 s against their solo renders, the tables staged once
    gen8 = torch.Generator(device=cuda)
    gen8.manual_seed(SEED)
    xf = torch.randn((SERVICES_FILES, 2, SERVICES_FILES_T), generator=gen8,
                     device=cuda) * 0.25
    got8 = []
    f_ms = cuda_ms(lambda: got8.append(skern.render_files(xf)))
    y8 = got8[0][0]
    rate8 = SERVICES_FILES * SERVICES_FILES_T / SR / (f_ms / 1e3)
    # each file alone: K11 on that one file from the fresh carry, the 8
    # solo launches on streams of their own (a file is a warp: they run
    # side by side); comparisons, not the main path
    bv1, bm1 = skern.initial_carry()
    saved, solos = DX.LAUNCHES, []
    for f in range(SERVICES_FILES):
        with torch.cuda.stream(torch.cuda.Stream()):
            solos.append(DX.device_exec(skern.program, xf[f:f + 1],
                                        bv1[None].clone(),
                                        bm1[None].clone())[0])
    torch.cuda.synchronize()
    DX.LAUNCHES = saved
    for f in range(SERVICES_FILES):
        check(torch.equal(y8[f], solos[f][0]),
              f"services: file {f} differs from its solo render")
    check(skern.tables.stagings == 1, f"services: the tables staged "
          f"{skern.tables.stagings} times for 8 files and their solos")
    print(f"[services] {SERVICES_FILES} files x 10 s through render_files: "
          f"every file torch.equal to its solo render; {f_ms:.1f} ms, "
          f"{rate8:.3f} audio-s per s; tables staged once card='{card}'")

    # 5. K11's bounds: the pool's bytes once and the audio, and the
    # voices' chain at a dependent add's latency (the latency probe)
    links = devexec_links(torch, cuda, DX, skern.program, card)
    ops = DX.sample_chain_ops(skern.program, {"NV": SERVICES_VOICES})
    chain_ms = MAIN_T * ops * links["add"] / 1e6
    nbytes = pool_bytes + 2 * (2 * MAIN_T * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms = max(chain_ms, bytes_ms)
    by = "operations" if chain_ms >= bytes_ms else "bytes"
    print(f"[services] K11 bounds: bytes {bytes_ms:.4f} ms ({nbytes} bytes: "
          f"the pool once, the audio in and out), chain {chain_ms:.2f} ms "
          f"({ops:.1f} dependent f64 operations a sample, a pool read "
          f"counted as one, x {links['add']:.3f} ns) card='{card}'")

    # 6. the golden, from its process
    rep, gold_s = sampler_golden_held(sprog, y, sampler.shadow.state, golden,
                                      t_start)
    print(f"[services] the sampler's 60 s render vs the native golden (audio "
          f"{AUDIO_EPS}, vars and heap {SCALAR_EPS}): {rep.summary()}; the "
          f"golden alone {gold_s:.2f} s on one host core "
          f"({sec / gold_s:.3f} audio-s per s)")
    check(rep.passed, "services: the sampler's render disagrees with the "
          "native golden")

    # 7. the leveler's 60 s render on K10, K10's inputs recorded at the
    # reload block (the first) and a steady one
    xl = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
    blocks = -(-MAIN_T // 512)
    steady = min(1000, blocks // 2)
    # K10's inputs recorded through the eager step (a K5 replay calls no
    # wrapper) on the blocks up to the steady one
    n_rec = (steady + 1) * 512
    got, spy, real_k10 = k10_recording({0, steady})
    BS.block_section = spy
    try:
        y_rec, _c = leveler.kernel._render_device_as(
            "eager", torch.from_numpy(xl[:, :n_rec]).to(cuda))
    finally:
        BS.block_section = real_k10
    BS.LAUNCHES = 0
    out = []
    t0 = time.perf_counter()
    l_ms = cuda_ms(lambda: out.append(leveler.render(xl)))
    l_wall = time.perf_counter() - t0
    l_launches = BS.LAUNCHES
    lres = out[0]
    check(lres.engine == "torch-vector" and l_launches == blocks,
          f"services: leveler {lres.engine}, {l_launches} K10 launches of "
          f"{blocks} blocks")
    check(lres.details.get("dispatch") == "graph" and torch.equal(
        torch.from_numpy(lres.audio[:, :n_rec]), y_rec.cpu()),
        f"services: the leveler ran as {lres.details.get('dispatch')}, or "
        "differs from the eager step's render")
    check(k10.tables.stagings == 1, f"services: the leveler's tables staged "
          f"{k10.tables.stagings} times")
    lrep, l_gold_s = held_to_native_golden(lprog, xl, lres.audio,
                                           leveler.shadow.state,
                                           host=table_host())
    print(f"[services] slot_table_leveler({SERVICES_TABLE}) 60 s stereo: "
          f"engine={lres.engine} device_ms={l_ms:.2f} wall_s={l_wall:.4f} "
          f"K10 launches {l_launches}; vs the native golden: "
          f"{lrep.summary()}; the golden {l_gold_s:.2f} s card='{card}'")
    check(lrep.passed, "services: the leveler's render disagrees with the "
          "native golden")
    k10_ms, k10_errs = {}, []
    for at, label in ((0, "reload"), (steady, "steady")):
        err, k10_plain_ms = k10_plain_held(
            got[at], f"services: K10 at the {label} block")
        k10_errs.append(err)
        if label == "reload":
            reload_plain_ms = k10_plain_ms
        work = got[at].copy()
        saved = BS.LAUNCHES
        k10_ms[label] = cuda_ms(lambda: work.run(BS.block_section), reps=20)
        BS.LAUNCHES = saved            # timing, not the main path
        print(f"[services] K10 at the {label} block ({at}): bit-identical to "
              f"its plain version (sample side, vars, heap, control row); "
              f"{k10_ms[label]:.4f} ms a launch (20 launches), the plain "
              f"version {k10_plain_ms:.1f} ms card='{card}'")
    copy_bytes = 2 * SERVICES_TABLE * 8
    k10_bound = copy_bytes / HBM_BYTES_PER_S * 1e3
    k11 = {"services_sampler_launches": launches, "services_sampler_ms": k_ms,
           "services_sampler_render_ms": ms,
           "services_sampler_audio_s_per_s": sec / (k_ms / 1e3),
           "services_sampler_golden_s": gold_s,
           "services_sampler_bound_ms": b_ms,
           "services_sampler_bound_by": by,
           "services_sampler_chain_ops": ops,
           "services_sampler_max_abs_err": max(errs),
           "services_sampler_plain_ms": plain_ms,
           "services_files_ms": f_ms, "services_files_audio_s_per_s": rate8,
           "services_pool_bytes": pool_bytes,
           "services_stagings": skern.tables.stagings}
    k10f = {"services_leveler_launches": l_launches,
            "services_leveler_render_ms": l_ms,
            "services_leveler_golden_s": l_gold_s,
            "services_reload_ms": k10_ms["reload"],
            "services_steady_ms": k10_ms["steady"],
            "services_reload_bound_ms": k10_bound,
            "services_plain_ms": reload_plain_ms,
            "services_max_abs_err": max(k10_errs)}
    return k11, k10f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="jsfx,batch,spectral,coupled,gated,hop,planner,"
                            "devexec,tooling,graph,services,faust",
                    help="comma-separated: jsfx, batch, spectral, coupled, "
                         "gated, hop, planner, devexec, tooling, graph, "
                         "services, faust (default all twelve); k4sweep "
                         "times K4 "
                         "across register block sizes")
    ap.add_argument("--sampler-golden", metavar="OUT", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.sampler_golden:
        # the services phase's child: the sampler's golden, no card
        return sampler_golden_child(args.sampler_golden)
    phases = set(args.phases.split(","))
    if not phases or phases - {"jsfx", "batch", "spectral", "coupled",
                               "gated", "hop", "planner", "devexec",
                               "tooling", "graph", "services", "faust",
                               "k4sweep"}:
        ap.error("--phases takes jsfx, batch, spectral, coupled, gated, hop, "
                 "planner, devexec, tooling, graph, services, faust or "
                 "k4sweep")
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import zorak_tpu_torch

    # the kernels must build from this checkout's sources, not an installed copy
    check(Path(zorak_tpu_torch.__file__).resolve().parents[1]
          == Path(__file__).resolve().parent,
          f"zorak_tpu_torch imported from {zorak_tpu_torch.__file__}, "
          "not from this checkout")
    from zorak_tpu_torch.kernels import _build

    # the native golden's libraries go beside the kernels', in the checkout
    os.environ.setdefault("ZORAK_TPU_CACHE", str(_build.BUILD_DIR))
    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED)

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build: one nvcc a source, all started together -----------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {', '.join(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            # K8 has a build a tile: name each kernel its lines belong to
            if "registers" in line or "spill" in line or (
                    name == "partition_mac" and "Function properties" in line):
                print(f"[build] {name}: {line.strip()}")

    # the sampler's golden takes minutes on one host core: it runs in a
    # process of its own from here, and the services phase waits for it
    golden = start_sampler_golden() if "services" in phases else None
    try:
        return run_phases(torch, cuda, rng, card, phases, golden, t_start)
    finally:
        if golden is not None and golden[0].poll() is None:
            golden[0].kill()
            golden[0].wait()


def run_phases(torch, cuda, rng, card, phases, golden, t_start) -> int:
    kernels = []
    ends = []          # each phase's end, in the script's seconds

    def ended(name):
        ends.append(f"{name} {time.perf_counter() - t_start:.1f}")

    if "jsfx" in phases:
        # 3. K2 and K3 against their plain versions; 4. the JSFX main path
        # a seeded stream of their own: the Faust phases draw the same
        # inputs whether or not these ran before them
        rng_jsfx = np.random.RandomState(SEED + 5)
        t0 = time.perf_counter()
        k2 = linrec_phase(torch, cuda, rng_jsfx)
        k3 = ring_taps_phase(torch, cuda, rng_jsfx)
        print(f"[done] K2 and K3 kernel phases in "
              f"{time.perf_counter() - t0:.1f} s")
        ended("K2 and K3")
        t0 = time.perf_counter()
        # a stream of its own again: K4's draws do not move the others'
        k4 = scan_group_phase(torch, cuda, np.random.RandomState(SEED + 6))
        print(f"[done] K4 kernel phase in {time.perf_counter() - t0:.1f} s")
        ended("K4")
        launches, reruns = jsfx_phase(torch, cuda, rng_jsfx, card)
        for entry in (k2, k3):
            entry["launches"] = launches["fallback"][entry["name"]]
            entry["launches_wide"] = launches["wide"][entry["name"]]
            entry["launches_cross_fed"] = launches["cross_fed"][entry["name"]]
        k4["launches"] = launches["follower"]["scan_group"]
        k4["launches_stereo"] = launches["stereo_followers"]["scan_group"]
        k4["render_rerun_steps"] = reruns["follower"]
        k4["render_rerun_steps_stereo"] = reruns["stereo_followers"]
        kernels += [k2, k3, k4]
        verify_cli_phase(card)
        print(f"[done] jsfx phases at {time.perf_counter() - t_start:.1f} s")
        ended("jsfx")
    if "batch" in phases:
        t0 = time.perf_counter()
        batch_kernels_phase(torch, cuda, np.random.RandomState(SEED + 8))
        print(f"[done] batch kernel phase in {time.perf_counter() - t0:.1f} s")
        ended("batch kernel")
        t0 = time.perf_counter()
        batched = batch_phase(torch, cuda, np.random.RandomState(SEED + 9),
                              card)
        for entry in kernels:
            if entry["name"] in batched:
                entry["launches_batched"] = batched[entry["name"]]
        print(f"[done] batch phase in {time.perf_counter() - t0:.1f} s; "
              f"launches of 8 files: {batched}")
        ended("batch")
    if "spectral" in phases:
        t0 = time.perf_counter()
        kernels += spectral_phase(torch, cuda, np.random.RandomState(SEED + 7),
                                  card)
        print(f"[done] spectral phase in {time.perf_counter() - t0:.1f} s")
        ended("spectral")
    if "coupled" in phases:
        t0 = time.perf_counter()
        kernels.append(coupled_phase(torch, cuda,
                                     np.random.RandomState(SEED + 10), card))
        print(f"[done] coupled phase in {time.perf_counter() - t0:.1f} s")
        ended("coupled")
    if "gated" in phases:
        t0 = time.perf_counter()
        gated = gated_phase(torch, cuda, np.random.RandomState(SEED + 11),
                            card)
        for entry in kernels:
            if entry["name"] == "linrec_scan":
                entry["launches_gated"] = gated["launches_gated"]
        kernels.append(gated.pop("k6_entry"))
        print(f"[done] gated phase in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps(gated)}")
        ended("gated")
    if "hop" in phases:
        t0 = time.perf_counter()
        hop = hop_phase(torch, cuda, np.random.RandomState(SEED + 12), card)
        k10 = [e for e in kernels if e["name"] == "block_section"]
        if k10:
            k10[0].update(hop)
        else:
            # the coupled phase did not run: K10's entry is the hop's
            kernels.append({
                "name": "block_section", "route": "cuda",
                "source": "zorak_tpu_torch/csrc/block_ops.cuh",
                "replaces": "zorak_tpu/lowering/devgen.py:463",
                "launches": hop["hop_launches"],
                "max_abs_err": hop["hop_max_abs_err"], "ms": hop["hop_ms"],
                "plain_ms": hop["hop_plain_ms"],
                "bound_ms": hop["hop_bound_ms"],
                "bound_by": hop["hop_bound_by"], "library_ms": None, **hop})
        print(f"[done] hop phase in {time.perf_counter() - t0:.1f} s")
        ended("hop")
    if "planner" in phases:
        t0 = time.perf_counter()
        planner = planner_phase(torch, cuda, np.random.RandomState(SEED + 17),
                                card)
        kernels.append(planner.pop("k3b_entry"))
        print(f"[done] planner phase in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps(planner)}")
        ended("planner")
    if "gated" in phases:
        k3b = [e for e in kernels if e["name"] == "dyn_ring_read"]
        tank = {"launches_gated": gated["k3b_launches_gated"],
                "ms_tank": gated["k3b_tank_ms"],
                "plain_ms_tank": gated["k3b_tank_plain_ms"]}
        if k3b:
            k3b[0].update(tank)
        else:
            # the planner phase did not run: K3b's entry is the tank's
            k6 = [e for e in kernels if e["name"] == "gated_index"][0]
            kernels.append({
                "name": "dyn_ring_read", "route": "cuda",
                "source": "zorak_tpu_torch/csrc/gated_index.cu",
                "replaces": "zorak_tpu/lowering/specialize.py:4432",
                "launches": tank["launches_gated"],
                "max_abs_err": k6["max_abs_err"], "ms": tank["ms_tank"],
                "plain_ms": tank["plain_ms_tank"],
                "bound_ms": k6["kernels_bound_ms"]["dyn_ring_read"]
                / GATED_K6_PER_SEGMENT["dyn_ring_read"],
                "bound_by": "bytes", "library_ms": None, **tank})
    if "devexec" in phases:
        t0 = time.perf_counter()
        kernels.append(devexec_phase(torch, cuda,
                                     np.random.RandomState(SEED + 13), card))
        print(f"[done] devexec phase in {time.perf_counter() - t0:.1f} s")
        ended("devexec")
    if "tooling" in phases:
        t0 = time.perf_counter()
        tooling = tooling_phase(torch, cuda, card)
        print(f"[done] tooling phase in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps(tooling)}")
        ended("tooling")
    if "graph" in phases:
        t0 = time.perf_counter()
        k10 = [e for e in kernels if e["name"] == "block_section"]
        graph = graph_phase(torch, cuda, np.random.RandomState(SEED + 14),
                            card, coupled_k10_ms=k10[0]["ms"] if k10
                            else None)
        if k10:
            k10[0].update(graph)
        else:
            # neither the coupled nor the hop phase ran: K10's entry is
            # the graph's
            kernels.append({
                "name": "block_section", "route": "cuda",
                "source": "zorak_tpu_torch/csrc/block_ops.cuh",
                "replaces": "zorak_tpu/lowering/devgen.py:463",
                "launches": graph["launches_graph"],
                "max_abs_err": graph["graph_max_abs_err"],
                "ms": graph["graph_ms_a_launch"],
                "plain_ms": graph["graph_plain_ms"],
                "bound_ms": graph["graph_bound_ms"],
                "bound_by": graph["graph_bound_by"], "library_ms": None,
                **graph})
        print(f"[done] graph phase in {time.perf_counter() - t0:.1f} s")
        ended("graph")
    if "services" in phases:
        t0 = time.perf_counter()
        k11f, k10f = services_phase(torch, cuda,
                                    np.random.RandomState(SEED + 16), card,
                                    golden, t_start)
        for name, fields, head in (
                ("device_exec", k11f, ("services_sampler_launches",
                                       "services_sampler_max_abs_err",
                                       "services_sampler_ms",
                                       "services_sampler_plain_ms",
                                       "services_sampler_bound_ms",
                                       "services_sampler_bound_by")),
                ("block_section", k10f, ("services_leveler_launches",
                                         "services_max_abs_err",
                                         "services_reload_ms",
                                         "services_plain_ms",
                                         "services_reload_bound_ms", None))):
            have = [e for e in kernels if e["name"] == name]
            if have:
                have[0].update(fields)
                continue
            # the phase that owns the kernel's entry did not run
            launches, err, ms, plain, bound, by = (
                fields[k] if k else None for k in head)
            kernels.append({
                "name": name, "route": "cuda",
                "source": ("zorak_tpu_torch/kernels/device_exec.py"
                           if name == "device_exec"
                           else "zorak_tpu_torch/csrc/block_ops.cuh"),
                "replaces": ("zorak_tpu/lowering/devexec.py:491"
                             if name == "device_exec"
                             else "zorak_tpu/lowering/devgen.py:463"),
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound,
                "bound_by": by or "bytes", "library_ms": None, **fields})
        print(f"[done] services phase in {time.perf_counter() - t0:.1f} s")
        ended("services")
    if "k4sweep" in phases:
        scan_group_sweep(torch, cuda, np.random.RandomState(SEED))
    if "faust" in phases:
        t0 = time.perf_counter()
        kernels[:0] = faust_phases(torch, cuda, rng, card)
        print(f"[done] faust phases in {time.perf_counter() - t0:.1f} s")
        ended("faust")
    print(f"[done] {time.perf_counter() - t_start:.1f} s; the phases end at "
          f"(s of the script): {', '.join(ends)}")
    print("[k5] " + json.dumps({"k5": K5_ROWS}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
