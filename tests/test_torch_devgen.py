"""The device section compiler (lowering/devgen.py) and K10's two CPU forms
against the JAX package's traced device sections.

Each case of tests/test_devgen.py that needs no gmem and no message bus
runs its @block for a few blocks three ways from one seeded state (the
snapshot's vars, its heap with seeded noise in the first 1,024 cells):
the JAX `DeviceSection.step`, K10's plain version (`block_section_plain`,
the port's Python golden with the device heap's addressing) and K10's
generated source in its host form (`block_section_host`, g++ -O2
-ffp-contract=off).  The host form equals the plain version bit for bit
(every NaN one value), apart from sections with an FFT, whose heap cells
are held within `FFT_TOL_REL` of the heap's largest magnitude and whose
vars within `FFT_TOL_REL` of their own (a radix-2 against NumPy's FFT).
Both are held to JAX within 1e-8 on every var slot but the function
params (the C functions take them as arguments) and on the plugin heap.
The host form's phases, with 1, 3 and 128 threads in both orders, equal
its one-thread form bit for bit; the cases include the phases through a
user function called as a statement (nested once, its value used
elsewhere), block copies (overlapping runs both ways, lengths <= 0 and
not whole), counted `while` loops (a start that is not an integer, no
trips, `<=`, a bound past the heap) and loops whose bodies hold block
phases, and the host form's count of the barriers they pass.
"""
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zorak_tpu.ir.program import compile_plugin_source as jax_compile
from zorak_tpu.lowering import devgen as jax_devgen
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import block_section as BS
from zorak_tpu_torch.lowering.devgen import (
    DeviceSection, DevgenError, section_dynamic_keys)
from zorak_tpu_torch.verify import make_initialized_shadow

JAX_TOL = 1e-8


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def host_compiler():
    try:
        return _build.find_host_compiler()
    except RuntimeError:
        return None


PRED = "@init\nctr = 0;\n@block\nctr += 1;\n"

# name -> (source, blocks, heap cells, samplesblock)
CASES = {
    "math_and_state": ("""
@init
a = 1; t = 0;
@block
t += samplesblock;
a = a * 0.9 + 0.1;
b = sin(a) + max(t, 3) + (t > 1000 ? 7 : 2);
""", 3, 1 << 16, 512),
    "loops_and_mem": ("""
@init
base = 100;
@block
i = 0;
loop(37, base[i] = i*2 + k; i += 1;);
k += 1;
acc = 0; j = 0;
while(j < 37) ( acc += base[j]; j += 2; );
""", 3, 1 << 16, 512),
    "branches_and_instance_fns": ("""
@init
function env(x) instance(z) ( z = z*0.5 + x; z );
@block
m1.env(cnt); m2.env(cnt*2);
cnt += 1;
cnt > 2 ? ( flip = !flip; memset(50, cnt, 20); ) : ( other = cnt/3; );
""", 3, 1 << 16, 512),
    "fft_roundtrip": ("""
@init
FS = 1024; buf = 4096;
i = 0; loop(2*FS, buf[i] = 0; i += 1;);
buf[6] = 1; buf[33] = 0.5;
@block
fft(buf, FS);
fft_permute(buf, FS);
g = buf[9];
fft_ipermute(buf, FS);
ifft(buf, FS);
i = 0; loop(2*FS, buf[i] = buf[i] / FS; i += 1;);
""", 2, 1 << 16, 512),
    "fft_real_roundtrip": ("""
@init
N = 512; buf = 8192;
i = 0; loop(N, buf[i] = sin(i*0.1) + 0.2*i/N; i += 1;);
@block
fft_real(buf, N);
fft_permute(buf, N/2);
q = buf[3];
fft_ipermute(buf, N/2);
ifft_real(buf, N);
i = 0; loop(N, buf[i] = buf[i] * 0.5 / N; i += 1;);
""", 2, 1 << 16, 512),
    "convolve_c": ("""
@init
N = 64; a = 1000; b = 2000;
i = 0; loop(2*N, a[i] = sin(i*.3); b[i] = cos(i*.2); i += 1;);
@block
convolve_c(a, b, N);
chk = a[5] + a[77];
""", 1, 1 << 14, 512),
    "addbuf_shape": ("""@init
A = 0; B = 256; N = 128;
i = 0;
while (i < N) ( A[i] = i * 0.5; B[i] = 1 + i; i += 1; );
@block
i = 0;
while (i < N) ( A[i] += B[i] * 0.25; i += 1; );
k = i;
@sample
spl0 = spl0;
""", 1, 1 << 12, 64),
    "two_buffer_overlap_add": ("""@init
ACC = 0; OV = 512; WET = 768; P = 200;
i = 0;
while (i < 2*P) ( ACC[i] = i + 1; i += 1; );
i = 0;
while (i < P) ( OV[i] = 1000 + i; i += 1; );
@block
sc = 0.5;
i = 0;
while (i < P) (
  WET[i] = OV[i] + ACC[i] * sc;
  OV[i] = ACC[i + P] * sc;
  i += 1;
);
@sample
spl0 = spl0;
""", 1, 1 << 11, 64),
    "cross_iteration_recurrence": ("""@init
X = 0; Y = 300; N = 64;
i = 0;
while (i < N) ( X[i] = i; i += 1; );
Y[0] = 0;
@block
i = 1;
while (i < N) ( Y[i] = Y[i - 1] + X[i]; i += 1; );
@sample
spl0 = spl0;
""", 1, 1 << 10, 64),
    "static_while_keeps_handle": ("""@init
T = 0;
@block
h = 3;
n = 100;
i = 0;
while (i < n) ( T[i] = spl_probe + i; i += 1; );
hh = h * 2;
@sample
spl_probe = spl0;
spl0 = spl0;
""", 1, 1 << 10, 64),
    "mem_writes_both_arms": (PRED + """
odd = ctr % 2;
odd ? (mem[10 + ctr] = ctr; tag = 1;)
    : (mem[40 + ctr] = -ctr; tag = 2;);
""", 4, 1 << 16, 512),
    "nested_branches": (PRED + """
a = ctr % 2; b = ctr % 3;
a ? (
  b ? mem[ctr] = 7 : (mem[ctr] = 9; u = ctr;);
  v = u + 1;
) : (
  b ? (w = w + 1; mem[100] = w;);
);
""", 4, 1 << 16, 512),
    "untaken_arm_garbage_address": (PRED + """
neg = -(ctr % 2);
neg ? (j = neg * 987654321; j[0] = 5;) : (mem[3] = ctr;);
check = mem[3];
""", 4, 1 << 16, 512),
    "bulk_ops_under_predicate": (PRED + """
src = 200; dst = 300;
i = 0; loop(16, src[i] = ctr * 10 + i; i += 1;);
(ctr % 2) ? (
  memcpy(dst, src, 16);
  memset(400, ctr, 8);
);
probe = mem[300] + mem[407];
""", 4, 1 << 16, 512),
    "while_loop_in_arm": (PRED + """
go = ctr % 2;
go ? (
  n = ctr * 3; i = 0; acc = 0;
  while (i < n) ( acc += i; i += 1; );
  mem[50] = acc;
) : (
  mem[60] = ctr;
);
""", 4, 1 << 16, 512),
    "dynamic_loop_in_arm": (PRED + """
k = ctr % 3;
k ? (
  i = 0;
  loop(k * 5, mem[70 + i] = i + ctr; i += 1;);
);
""", 4, 1 << 16, 512),
    "fft_under_predicate": (PRED + """
buf = 512;
i = 0; loop(64, buf[i] = sin(i * 0.3 + ctr); i += 1;);
(ctr % 2) ? (
  fft_real(buf, 64);
  fft_ipermute(buf, 32);
);
probe = mem[512] + mem[513];
""", 4, 1 << 16, 512),
    "value_of_branch_expression": (PRED + """
x = (ctr % 2) ? (mem[5] = ctr; ctr * 2.0) : (ctr - 1.0);
y = x + mem[5];
""", 4, 1 << 16, 512),
    "logical_ops_with_assigning_rhs": (PRED + """
a = (ctr % 2) && (t1 = ctr; mem[80] = t1; 1);
b = (ctr % 2) || (t2 = ctr * 3; mem[81] = t2; 0);
s = t1 + t2 + mem[80] + mem[81];
""", 4, 1 << 16, 512),
    # the heap clamp: dynamic addresses past the heap and below 0
    "heap_clamp": ("""
@block
ctr += 1;
hi = 5000 + ctr; lo = -3 - ctr;
mem[hi] = ctr * 2;
mem[lo] = ctr * 3;
r = mem[hi + 7] + mem[lo - 9];
memset(hi - 2, ctr, 6);
""", 3, 1 << 12, 512),
    # the phase split: a block loop with temporaries, a masked and a
    # strided read, and a write at an offset
    "block_loop_with_temporaries": ("""
@init
R = 0; W = 2048; O = 4096; M = 1023;
i = 0; loop(1024, R[i] = sin(i * 0.01); W[i] = 0.5 + 0.5 * cos(i * 0.02);
  i += 1;);
@block
ctr += 1;
i = 0;
loop(700, s = R[(ctr * 7 + i) & M]; v = s * W[i]; O[i + 3] = v * v + s;
  i += 1;);
last = v + s + i;
""", 3, 1 << 14, 512),
    "two_transform_sizes": ("""
@init
A = 1000; C = 3000;
i = 0; loop(256, A[i] = sin(i * 0.37); i += 1;);
i = 0; loop(128, C[i] = cos(i * 0.21); i += 1;);
@block
fft_real(A, 256);
fft(C, 64);
q = A[3] + C[5];
ifft(C, 64);
""", 2, 1 << 14, 512),
    # block loops refused while printing: a flow from the last iteration's
    # cell, a temporary read before it is written, a user function
    "loop_reads_the_last_iterations_cell": ("""
@init
B = 100;
i = 0; loop(60, B[i] = i * 0.25; i += 1;);
@block
i = 0;
loop(50, B[i + 1] = B[i] * 0.5 + 1; i += 1;);
""", 2, 1 << 12, 512),
    "loop_temp_read_before_written": ("""
@init
T = 500;
@block
i = 0; p = 0.5;
loop(30, T[i] = p; p = i * 2 + p * 0.5; i += 1;);
""", 2, 1 << 12, 512),
    "loop_calls_a_user_function": ("""
@init
T = 700;
function f(x) ( x * 2 + 1 );
@block
ctr += 1;
i = 0;
loop(16, T[i] = f(i + ctr); i += 1;);
""", 2, 1 << 12, 512),
    # block loops that thread 0 runs itself where the run's values fail
    # the checks: a start that is not an integer (odd blocks), writes past
    # the heap (clamped), a dynamic base whose cells overlap the reads
    # (odd blocks)
    "loop_start_not_an_integer": ("""
@init
T = 200;
@block
ctr += 1;
i = 0.5 * ctr;
loop(40, T[i] = i * 2 + ctr; i += 1;);
""", 3, 1 << 12, 512),
    "loop_writes_past_the_heap": ("""
@init
T = 4070;
@block
ctr += 1;
i = 0;
loop(40, T[i] = i + ctr; i += 1;);
""", 2, 1 << 12, 512),
    "loop_overlap_at_run_time": ("""
@init
SRC = 300;
i = 0; loop(64, SRC[i] = i; i += 1;);
@block
ctr += 1;
dst = 340 - (ctr % 2) * 30;
i = 0;
loop(20, dst[i] = SRC[i] + ctr; i += 1;);
""", 3, 1 << 12, 512),
    # the phases through a user function called as a statement: its
    # arguments in the shared row, its locals in their slots, a block loop
    # over a parameter's cells, and a call nested once
    "function_phases_nested": ("""
@init
A = 1000; B = 3000; N = 64;
i = 0; loop(2*N, A[i] = sin(i*0.3); i += 1;);
function inner(dst, n) local(j) (
  memset(dst, 0.25, 40);
  j = 0;
  while (j < n) ( dst[j] += j * 0.5 + n; j += 1; );
);
function outer(k) local(q) (
  memcpy(B, A, 2*N);
  fft(B, N);
  inner(B + 2*N, k);
  q = B[3] + k;
  acc = q;
);
@block
ctr += 1;
outer(ctr + 10);
done = acc + B[2*N + 5];
""", 3, 1 << 14, 512),
    # block copies: overlapping runs both ways (thread 0 copies them, 2 a
    # block), a length <= 0, a non-integer length, a copy onto itself, a
    # dynamic source; memset with a non-integer length, a start clamped
    # at the heap's end, a negative length
    "block_copies": ("""
@init
S = 100;
i = 0; loop(64, S[i] = i + 0.5; i += 1;);
@block
ctr += 1;
memcpy(S + 10, S, 40);
memcpy(S, S + 5, 30);
memcpy(400, S, -3);
memcpy(500, S + 2, 7.9);
memcpy(600, S, 0);
memcpy(S + 3, S + 3, 10);
memcpy(700, S + ctr, 16);
memset(200 + ctr, ctr * 0.5, 33.7);
memset(3990 + ctr, -1, 200);
memset(300, 7, -5);
chk = mem[510] + mem[706] + mem[210] + mem[4095];
""", 3, 1 << 12, 512),
    # counted while loops: a start that is not an integer (odd blocks:
    # thread 0 runs it), no trips, `<=`, and a bound past the heap (its
    # writes clamp: thread 0 runs it)
    "counted_while_edges": ("""
@init
T = 100; U = 600;
@block
ctr += 1;
i = 0.5 * ctr;
while (i < 40) ( T[i] = i * 2 + ctr; i += 1; );
j = 50;
while (j < 10) ( U[j] = 1; j += 1; );
k = ctr;
while (k <= 30) ( U[k] = k * k; k += 1; );
m = 3;
while (m < 5000) ( mem[m] = m + ctr; m += 1; );
last = i + j + k + m;
""", 3, 1 << 12, 512),
    # loops whose bodies hold block phases: a while with a data-dependent
    # condition around a copy and an FFT, and a loop(n) around a memset
    # and a permutation
    "loop_with_fft_and_copy": ("""
@init
W = 1000; N = 32; A = 2000;
i = 0; loop(2*N, A[i] = cos(i * 0.2); i += 1;);
@block
ctr += 1;
e = 0; p = 0;
while (e < 3 + (ctr % 2) && p < 5) (
  memcpy(W, A + p, 2*N);
  fft(W, N);
  e += abs(W[2]) > 0.1 ? 1 : 0.5;
  p += 1;
);
loop(2, memset(W + 2*N, e, 4); fft_permute(W, N););
res = e + p + W[5];
""", 3, 1 << 14, 512),
    # a function whose value is used stays on thread 0; called as a
    # statement, its body's phases run in place
    "function_value_used_stays_serial": ("""
@init
function f(x) local(t) ( memset(300, x, 4); fft(400, 16); t = x * 2; t + 1 );
i = 0; loop(32, mem[400 + i] = i * 0.1; i += 1;);
@block
ctr += 1;
y = f(ctr);
f(ctr + 1);
z = y + mem[301] + mem[402];
""", 3, 1 << 12, 512),
}

# name -> the kinds of @block's phases (DeviceSection.phases)
PHASES = {
    "loops_and_mem": ["serial", "loop", "serial"],
    "fft_roundtrip": ["fft", "fft", "serial", "fft", "fft", "serial",
                      "loop"],
    "fft_real_roundtrip": ["fft", "fft", "serial", "fft", "fft", "serial",
                           "loop"],
    "convolve_c": ["fft", "serial"],
    "fft_under_predicate": ["serial", "loop", "serial"],
    "block_loop_with_temporaries": ["serial", "loop", "serial"],
    "two_transform_sizes": ["fft", "fft", "serial", "fft"],
    "loop_reads_the_last_iterations_cell": ["serial"],
    "loop_temp_read_before_written": ["serial"],
    "loop_calls_a_user_function": ["serial"],
    "loop_start_not_an_integer": ["serial", "loop"],
    "loop_writes_past_the_heap": ["serial", "loop"],
    "loop_overlap_at_run_time": ["serial", "loop"],
    "function_phases_nested": ["serial", "serial", "copy", "fft", "serial",
                               "copy", "serial", "loop", "serial",
                               "serial"],
    "block_copies": ["serial"] + ["copy"] * 10 + ["serial"],
    "counted_while_edges": ["serial", "loop", "serial", "loop", "serial",
                            "loop", "serial", "loop", "serial"],
    "loop_with_fft_and_copy": [
        "serial", ("while", ["copy", "fft", "serial"]),
        ("repeat", ["copy", "fft"]), "serial"],
    "function_value_used_stays_serial": ["serial", "serial", "copy", "fft",
                                         "serial", "serial"],
}
# name -> why the printer keeps its loop on thread 0
KEPT_SERIAL = {
    "loop_reads_the_last_iterations_cell": "another iteration's cell",
    "loop_temp_read_before_written": "p is read before it is written",
    "loop_calls_a_user_function": r"a call with an effect: \S*f\(\)",
}
# name -> block loops thread 0 runs itself over the case's blocks
SERIAL_RUNS = {"loop_start_not_an_integer": 2,
               "loop_writes_past_the_heap": 2,
               "loop_overlap_at_run_time": 2,
               "block_copies": 6,
               "counted_while_edges": 5}
# (threads, descending) of the host form's phases
TEAMS = [(1, False), (3, False), (3, True), (128, False), (128, True)]


def seeded_state(dev, seed=11):
    v = dev.initial_vars()
    m = dev.initial_mem()
    m[:1024] += np.random.RandomState(seed).randn(1024) * 0.5
    return v, m


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """(JAX section, its vars and heap after each block)."""
    src, n_blocks, mem_size, B = CASES[name]
    prog = jax_compile(src)
    snap = jax_shadow(prog, 48000.0).state
    dev = jax_devgen.DeviceSection(
        prog, snap, "block",
        jax_devgen.section_dynamic_keys(prog, ("block", "sample")),
        mem_size, consts={"samplesblock": float(B)})
    v, m = seeded_state(dev)
    step = jax.jit(dev.step)
    v, m = jnp.asarray(v), jnp.asarray(m)
    out = []
    for _ in range(n_blocks):
        v, m = step(v, m)
        out.append((np.asarray(v), np.asarray(m)))
    return dev, out


def port_program(name):
    src, _n, mem_size, _B = CASES[name]
    prog = compile_plugin_source(src)
    snap = make_initialized_shadow(prog, 48000.0).state
    dev = DeviceSection(prog, snap, "block",
                        section_dynamic_keys(prog, ("block", "sample")),
                        mem_size)
    return dev, BS.BlockSectionProgram(dev, None, 0, [], [], [], [])


def run_port(name, form, **kw):
    """The port's vars and heap after each block, through `form`."""
    _src, n_blocks, _mem, B = CASES[name]
    dev, prog = port_program(name)
    v, m = seeded_state(dev)
    v = torch.from_numpy(v)[None].contiguous()
    m = torch.from_numpy(m)[None].contiguous()
    svec = torch.zeros((1, 0), dtype=torch.float64)
    out = []
    for _ in range(n_blocks):
        form(prog, svec, [], v, m, float(B), **kw)
        out.append((v[0].numpy().copy(), m[0].numpy().copy()))
    return dev, prog, out


def held_to_jax(dev, jdev, got, want):
    assert dev.slots == jdev.slots and dev.n_vars == jdev.n_vars
    n = dev.mem_size
    keep = [s for k, s in dev.slots.items() if k[0] != "param"]
    for (v, m), (jv, jm) in zip(got, want):
        assert np.allclose(v[keep], jv[keep], rtol=0, atol=JAX_TOL,
                           equal_nan=True)
        assert np.allclose(m[:n], jm[:n], rtol=0, atol=JAX_TOL,
                           equal_nan=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax(name):
    jdev, want = jax_run(name)
    dev, _prog, got = run_port(name, BS.block_section_plain)
    held_to_jax(dev, jdev, got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_form_matches_the_plain_version(name):
    if host_compiler() is None:
        pytest.skip("no host C++ compiler (g++, gcc, c++, cc) for the "
                    "generated source's host form")
    dev, prog, plain = run_port(name, BS.block_section_plain)
    _dev, _prog, host = run_port(name, BS.block_section_host)
    has_fft = bool(prog.perm_sizes)
    for (v, m), (hv, hm) in zip(plain, host):
        if has_fft:
            assert BS.fft_excess(torch.from_numpy(hm), torch.from_numpy(m),
                                 torch.from_numpy(hv),
                                 torch.from_numpy(v)) <= 0.0
        else:
            assert np.array_equal(hv, v, equal_nan=True)
            assert np.array_equal(hm, m, equal_nan=True)
    jdev, want = jax_run(name)
    held_to_jax(dev, jdev, host, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_form_phases_equal_the_one_thread_form(name):
    """K10's phases in the host form, with 1, 3 and 128 threads whose
    shares of each block step run in ascending and in descending order,
    equal the one-thread form bit for bit (vars, and the heap with its FFT
    buffers) after every block; thread 0 runs the loops it must."""
    if host_compiler() is None:
        pytest.skip("no host C++ compiler (g++, gcc, c++, cc) for the "
                    "generated source's host form")
    _dev, _prog, one = run_port(name, BS.block_section_host)
    for threads, desc in TEAMS:
        runs = []

        def form(*a, **kw):
            runs.append(BS.block_section_host(*a, **kw)[2])
        _d, _p, team = run_port(name, form, threads=threads,
                                descending=desc)
        for (v, m), (tv, tm) in zip(one, team):
            assert np.array_equal(v.view(np.int64), tv.view(np.int64)), \
                (threads, desc)
            assert np.array_equal(m.view(np.int64), tm.view(np.int64)), \
                (threads, desc)
        assert sum(runs) == SERIAL_RUNS.get(name, 0), (threads, desc, runs)


def kinds(phases):
    """The phases' kinds, a loop phase as (kind, its body's kinds)."""
    return [(ph.kind, kinds(ph.body)) if ph.body else ph.kind
            for ph in phases]


def flat(phases):
    """Every phase, a loop phase's body after it."""
    for ph in phases:
        yield ph
        yield from flat(ph.body)


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_split(name):
    dev, prog = port_program(name)
    assert kinds(dev.phases) == PHASES[name]
    if name in KEPT_SERIAL:
        assert len(dev.serial_loops) == 1
        assert re.search(KEPT_SERIAL[name], dev.serial_loops[0])
    # the phases print into the kernel's one team function; a block loop
    # and a block copy are one block step of their own each
    assert prog.source.count("ZB_DEV void zb_run_team(") == 1
    assert prog.source.count("ZB_STEPS(team,") == sum(
        ph.kind in ("loop", "copy") for ph in flat(dev.phases))


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_form_counts_the_barriers(name):
    """The host form counts the barriers the phases pass (thread 0's runs
    and the block steps): for a section without loop phases, the count
    `barriers_a_launch` places; with them, a count the run decides."""
    if host_compiler() is None:
        pytest.skip("no host C++ compiler (g++, gcc, c++, cc) for the "
                    "generated source's host form")
    dev, prog = port_program(name)
    counts = []

    def form(*a, **kw):
        BS.block_section_host(*a, barriers=counts, **kw)
    run_port(name, form, threads=3)
    exch = 3 if prog.v_shared else 2
    assert len(counts) == CASES[name][1] and min(counts) > 0
    if any(ph.body for ph in dev.phases):
        with pytest.raises(ValueError, match="count them"):
            BS.barriers_a_launch(prog)
        assert BS.barriers_a_launch(prog, counts[0]) == exch + counts[0]
    else:
        assert counts == [BS.barriers_a_launch(prog) - exch] * len(counts)


def test_phases_of_the_stand_in():
    """spectral_tilt_leveler(2048)'s @block: the window loop, fft_real
    and fft_permute across the block, the band loop (a sum carried from
    one iteration to the next) and the scalar updates on thread 0."""
    prog = compile_plugin_source(builtin_plugins.spectral_tilt_leveler(2048))
    snap = make_initialized_shadow(prog, 48000.0).state
    dev = DeviceSection(prog, snap, "block",
                        section_dynamic_keys(prog, ("block", "sample")),
                        1 << 23)
    assert [(ph.kind, ph.label) for ph in dev.phases] == [
        ("serial", "4 statements"), ("loop", "loop over i"),
        ("fft", "fft_real(2048)"), ("fft", "fft_permute(1024)"),
        ("serial", "8 statements")]
    assert len(dev.serial_loops) == 1
    assert "no assignment" in dev.serial_loops[0]
    k10 = BS.BlockSectionProgram(dev, None, 0, [], [], [], [])
    # the exchanges' 3, one after each of thread 0's 4 runs, the loop's
    # 1, fft_real's 13 (load, 11 stages, store), fft_permute's 2
    assert BS.barriers_a_launch(k10) == 23


def test_threads_are_a_build_parameter():
    dev, prog = port_program("loops_and_mem")
    assert prog.threads == BS.THREADS
    assert f"#define ZB_THREADS {BS.THREADS}" in prog.source
    wide = BS.BlockSectionProgram(dev, None, 0, [], [], [], [], threads=1024)
    assert "#define ZB_THREADS 1024" in wide.source
    for bad in (0, 1025, 2.0, True):
        with pytest.raises(ValueError, match="threads"):
            BS.BlockSectionProgram(dev, None, 0, [], [], [], [], threads=bad)


def test_heap_clamp_lands_on_the_edges():
    dev, prog, out = run_port("heap_clamp", BS.block_section_plain)
    n = dev.mem_size
    v, m = out[-1]
    ctr = v[dev.slots[("var", "ctr")]]
    assert ctr == 3.0
    # the memset run [hi - 2, hi + 4) is clamped to end at the heap's end
    assert np.all(m[n - 6:n] == ctr)
    assert m[0] == ctr * 3       # below 0 -> cell 0
    assert m[n:].size == 0       # no MIDI out table: the heap is the row


def test_static_address_past_the_heap_is_refused():
    prog = compile_plugin_source("@block\nmem[70000] = 1;\n")
    snap = make_initialized_shadow(prog, 48000.0).state
    with pytest.raises(DevgenError, match="beyond device heap"):
        DeviceSection(prog, snap, "block",
                      section_dynamic_keys(prog, ("block",)), 1 << 12)
    prog = compile_plugin_source("@block\nmemset(4090, 1, 16);\n")
    with pytest.raises(DevgenError, match="beyond device heap"):
        DeviceSection(prog, make_initialized_shadow(prog, 48000.0).state,
                      "block", section_dynamic_keys(prog, ("block",)),
                      1 << 12)


def test_forbidden_builtins_raise():
    # rand(): the reference's coupled @block has no draw pool either
    src = "@block\nx = rand(4);\n"
    prog = compile_plugin_source(src)
    snap = make_initialized_shadow(prog, 48000.0).state
    with pytest.raises(DevgenError, match="slice 6b"):
        DeviceSection(prog, snap, "block",
                      section_dynamic_keys(prog, ("block",)), 1 << 12)
    jprog = jax_compile(src)
    with pytest.raises(jax_devgen.DevgenError):
        jax_devgen.DeviceSection(
            jprog, jax_shadow(jprog, 48000.0).state, "block",
            jax_devgen.section_dynamic_keys(jprog, ("block",)), 1 << 12)


@pytest.mark.parametrize("body,match", [
    ("y = gmem_seq(0);", "through the golden"),
    ("y = gmem_page(x);", "through the golden"),
    ("n = msg_recv_buf(1, s, t, 0, 8);", "through the golden"),
    ("h = file_open(x);", "non-static arguments"),
    ("s = file_string(0, x);", "no slice brings it"),
    ("t = track_name(x);", "no slice brings it"),
    ("midisend_buf(0, 100, 3);", "no slice brings it"),
    ("slider(x) = 3;", "no slice brings it"),
])
def test_refusals_name_the_slice_that_brings_them(body, match):
    prog = compile_plugin_source(f"@block\nx = x + 1;\n{body}\n")
    snap = make_initialized_shadow(prog, 48000.0).state
    with pytest.raises(DevgenError, match=match):
        DeviceSection(prog, snap, "block",
                      section_dynamic_keys(prog, ("block",)), 1 << 12)


def test_generated_source_is_one_function_a_section():
    dev, prog = port_program("branches_and_instance_fns")
    assert prog.source.count("ZB_DEV void zb_section_block(ZB* S)") == 1
    # the instance function prints once, with its prototype
    name = next(iter(dev.functions))
    assert prog.source.count(f"double {name}(") == 2
    assert 'extern "C" int block_section_launch(' in prog.source
    assert 'extern "C" int block_section_host(' in prog.source
    # the earlier design (thread 0 runs zb_run, the one function a
    # section) is built beside the probes only
    assert "zb_kernel_earlier" not in prog.source
    probe = BS.BlockSectionProgram(dev, None, 0, [], [], [], [], probe=True)
    assert probe.source.count("ZB_DEV void zb_section_block(ZB* S)") == 1
    assert "if (t == 0) zb_run(&S);" in probe.source
    assert 'extern "C" int block_section_launch_earlier(' in probe.source
