"""JSFX plugins that ship with the package.

`FALLBACK_SRC` is the in-repo plugin shaped like the catalog's DDT delay
network: a stereo ring delay network with 16 taps a channel, two
one-pole recurrences and an induction cursor (the same text as the JAX
package's entry script carries).  `wide_delay_network(n_taps)` is the
same network at a catalog plugin's scale: its own tap tables, a larger
ring and delays spread over most of it.  `cross_fed_delay_network` feeds
the right ring from the left tap sum, so the right sum depends on the
left one within a sample.  `spectral_tilt_leveler(fft_size)` has an
audio-coupled @block of a catalog plugin's width (the shape of the
catalog's SpectralStabilizer and ERBTilt): @block reads and resets the
meters @sample accumulates and takes the FFT of the ring @sample fills.
`gated_fdn_tank(lines, buf)` is a feedback delay network whose cursor
advances only while the input is loud (the gated regime, the shape of
the catalog's 3DPanner sceneverb tank), and `hop_convolver(part, parts)`
a partitioned convolver that fires its FFT work every `part` samples
from inside @sample (the hop regime, the shape of the catalog's
PsychoConvolver).  `grain_texture(grains, ring)` is a granular texture at
the catalog's Texture widths (grain records of 19 doubles, reached
through an order table in memory; ring reads clamped by a block-rate fill
level; rand() in @block and @sample): the vectorizer rejects it, and the
sequential device executor (devexec, K11) renders it.
`scene_voice_panner(voices, scene)` is a voice panner linked to a scene
manager through its instance id, the bus and a gmem scene table (the
shape of the catalog's 3DPanner): a level-driven voice loop the
vectorizers reject, rendered by K11 with gmem in its heap row's window.
`crossmix_declutter(slot, n_slots)` is one instance of a cross-mix
declutter session (the shape of the catalog's CMD pair): each instance
publishes its block energy into a shared gmem slot, ducks against the
loudest of its peers' slots, broadcasts its energy on a bus channel and
drains what its peers sent, so a graph of them renders in the lockstep.
`pool_sampler(voices, samples)` plays voices over the sample pool that
its @init builds from file slot 0 (the shape of the catalog's Sample):
the vectorizer rejects its traced pool reads, and K11 gathers them.
`slot_table_leveler(frames)` loads a table from file slot 0 in @block
under a reload flag and reads it through a cursor in @sample (the shape
of PsychoConvolver's `load_raw_ir`): the load folds into K10's @block.
`sampler_slot` and `table_slot` make the slots' audio from a seed.
`modulated_delay_chorus(voices, buf)` is a chorus whose voices read the
rings at delays that a sine LFO moves every sample (the shape of the
catalog's DPT): the vectorizer plans it with dynamic ring reads.
`tpdf_dither(bits)` adds triangular dither from four ungated rand()
draws a sample before it quantises (the shape of the catalog's SOMA and
BedRock noise): the vector path's fresh-render draw matrix.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

FALLBACK_SRC = """\
desc:multi-tap delay network (entry fallback)
slider1:40<0,100,1>Amount

@init
BUF = 4096; MASK = BUF - 1;
bL = 0; bR = BUF;
i = 0;
loop(16,
  dT[i] = 32 + ((i*317) % 1500);
  gT[i] = 0.04 + 0.01*(i % 5);
  i += 1;
);
aLP = 0.995;

@slider
wet = slider1 / 100;

@sample
mem[bL + (w & MASK)] = spl0;
mem[bR + (w & MASK)] = spl1;
sumL = 0; sumR = 0;
i = 0;
loop(16,
  d = dT[i] | 0;
  sumL += gT[i] * mem[bL + ((w - d) & MASK)];
  sumR += gT[i] * mem[bR + ((w - d) & MASK)];
  i += 1;
);
zL = (1-aLP)*sumL + aLP*zL;
zR = (1-aLP)*sumR + aLP*zR;
spl0 = spl0*(1-wet) + zL*wet;
spl1 = spl1*(1-wet) + zR*wet;
w += 1;
"""


def wide_delay_network(n_taps: int = 192, buf: int = 16384,
                       max_delay: int = 12000) -> str:
    """The delay network widened to `n_taps` taps a channel.

    The ring holds `buf` samples a channel (a power of two) and the tap
    delays spread from 32 to about `max_delay` samples; the tap tables
    live above the two rings.
    """
    if buf & (buf - 1) or not 0 < max_delay < buf - 32:
        raise ValueError("buf must be a power of two larger than max_delay")
    return f"""\
desc:multi-tap delay network ({n_taps} taps a channel)
slider1:40<0,100,1>Amount

@init
BUF = {buf}; MASK = BUF - 1;
bL = 0; bR = BUF;
dT = 2*BUF; gT = 2*BUF + {n_taps};
i = 0;
loop({n_taps},
  dT[i] = 32 + ((i*317) % {max_delay - 32});
  gT[i] = (0.04 + 0.01*(i % 5)) * 16 / {n_taps};
  i += 1;
);
aLP = 0.995;

@slider
wet = slider1 / 100;

@sample
mem[bL + (w & MASK)] = spl0;
mem[bR + (w & MASK)] = spl1;
sumL = 0; sumR = 0;
i = 0;
loop({n_taps},
  d = dT[i] | 0;
  sumL += gT[i] * mem[bL + ((w - d) & MASK)];
  sumR += gT[i] * mem[bR + ((w - d) & MASK)];
  i += 1;
);
zL = (1-aLP)*sumL + aLP*zL;
zR = (1-aLP)*sumR + aLP*zR;
spl0 = spl0*(1-wet) + zL*wet;
spl1 = spl1*(1-wet) + zR*wet;
w += 1;
"""


def cross_fed_delay_network(n_taps: int = 16, buf: int = 4096,
                            max_delay: int = 1500, feed: float = 0.5) -> str:
    """The widened network with its right ring written from the left tap
    sum (`spl1 + feed * sumL`): the left ring is summed first, then the
    right ring is written and summed."""
    head = wide_delay_network(n_taps, buf, max_delay).split("@sample\n")[0]
    return head.replace("desc:", "desc:cross-fed ", 1) + f"""\
@sample
mem[bL + (w & MASK)] = spl0;
sumL = 0;
i = 0;
loop({n_taps},
  sumL += gT[i] * mem[bL + ((w - (dT[i] | 0)) & MASK)];
  i += 1;
);
mem[bR + (w & MASK)] = spl1 + {feed}*sumL;
sumR = 0;
i = 0;
loop({n_taps},
  sumR += gT[i] * mem[bR + ((w - (dT[i] | 0)) & MASK)];
  i += 1;
);
zL = (1-aLP)*sumL + aLP*zL;
zR = (1-aLP)*sumR + aLP*zR;
spl0 = spl0*(1-wet) + zL*wet;
spl1 = spl1*(1-wet) + zR*wet;
w += 1;
"""


def spectral_tilt_leveler(fft_size: int = 2048) -> str:
    """A stereo leveler with an audio-coupled @block.

    @sample writes the mid signal into a `fft_size`-cell masked ring,
    accumulates each channel's sum of squares into a meter, reads three
    constant-gain taps of the ring (a short diffuse echo) and applies a
    one-pole tilt filter whose coefficient, tilt gain and level gain come
    from @block.  @block, every block: reads and resets the meters, copies
    the ring into a Hann-windowed buffer (`loop(fft_size)`), takes
    `fft_real` of it, sums the low- and high-band energy over its
    fft_size / 2 bins, and derives and smooths the coefficient and the
    two gains."""
    n = int(fft_size)
    return f"""\
desc:spectral tilt leveler (coupled @block, FFT of the ring)

@init
N = {n}; HALF = N / 2; MASK = N - 1;
RING = 0; WIN = N; SPEC = 2 * N;
LOW = HALF / 8;
D1 = floor(N * 0.15); D2 = floor(N * 0.35); D3 = floor(N * 0.55);
i = 0;
loop(N, WIN[i] = 0.5 - 0.5 * cos(2 * $pi * i / N); i += 1;);
coef = 0.2; hg = 1; gain = 1;

@block
lvl = sqrt((e0 + e1) / max(2 * samplesblock, 1));
e0 = 0; e1 = 0;
i = 0;
loop(N, SPEC[i] = RING[(wp + i) & MASK] * WIN[i]; i += 1;);
fft_real(SPEC, N);
fft_permute(SPEC, HALF);
lo = 0; hi = 0; k = 0;
loop(HALF,
  p = sqr(SPEC[2 * k]) + sqr(SPEC[2 * k + 1]);
  k < LOW ? lo += p : hi += p;
  k += 1;
);
share = hi / (lo + hi + 1e-12);
coef += 0.2 * ((0.05 + 0.4 * share) - coef);
hg += 0.2 * (min(max(1.5 - 2 * share, 0.25), 4) - hg);
gain += 0.1 * ((lvl > 1e-6 ? min(0.25 / lvl, 4) : 1) - gain);

@sample
RING[wp & MASK] = 0.5 * (spl0 + spl1);
dly = 0.5 * RING[(wp - D1) & MASK] + 0.3 * RING[(wp - D2) & MASK] + 0.2 * RING[(wp - D3) & MASK];
wp += 1;
e0 += spl0 * spl0;
e1 += spl1 * spl1;
lp0 += coef * (spl0 - lp0);
lp1 += coef * (spl1 - lp1);
spl0 = gain * (lp0 + hg * (spl0 - lp0)) + 0.1 * dly;
spl1 = gain * (lp1 + hg * (spl1 - lp1)) + 0.1 * dly;
"""


def gated_fdn_tank(lines: int = 8, buf: int = 8192) -> str:
    """A stereo feedback delay network in the gated regime.

    `lines` rings of `buf` cells share one write cursor `w` that advances
    only in samples whose input level passes a threshold (the gate).  In
    the gate's branch each line reads a static tap (1,500 to 4,000 cells
    behind the cursor) and a tap whose delay comes from @block's control
    and is clamped through selects (2,000 to 3,500 cells, plus 37 a line),
    runs a one-pole lowpass over the two, and writes the input, a
    Householder mix of the lowpasses and a gated rand() dither into its
    ring.  The taps reach 4,000 cells, so the plan cuts the segment to
    1,024 samples (L <= the shortest delay, L <= buf - the longest)."""
    n, m = int(lines), int(buf)
    delays = [1500 + (i * 2500) // max(1, n - 1) for i in range(n)]
    taps = "\n".join(
        f"  t{i} = mem[{i * m} + ((w - {d}) & MASK)];\n"
        f"  u{i} = mem[{i * m} + ((w - d{i}) & MASK)];\n"
        f"  lp{i} = 0.6 * lp{i} + 0.4 * (0.7 * t{i} + 0.3 * u{i});"
        for i, d in enumerate(delays))
    dyn = "\n".join(f"d{i} = floor({2000 + 37 * i} + 1500 * sz);"
                    for i in range(n))
    total = " + ".join(f"lp{i}" for i in range(n))
    writes = "\n".join(
        f"  mem[{i * m} + w] = spl{i % 2} * 0.5 + 0.3 * (lp{i} - mix) + dn;"
        for i in range(n))
    left = " + ".join(f"lp{i}" for i in range(0, n, 2))
    right = " + ".join(f"lp{i}" for i in range(1, n, 2)) or "0"
    return f"""\
desc:gated FDN tank (gated cursor, taps in carry history, gated rand)

@init
MASK = {m - 1};
w = 0; bsize = 0;

@block
bsize = bsize + 0.013;
bsize > 1 ? bsize = 0;

@sample
sz = bsize;
sz < 0 ? sz = 0;
sz > 1 ? sz = 1;
{dyn}
g = max(abs(spl0), abs(spl1)) > 0.05;
g ? (
{taps}
  mix = {2.0 / n} * ({total});
  dn = (rand(2) - 1) * 1e-4;
{writes}
  w = (w + 1) & MASK;
);
spl0 = spl0 + {2.0 / n} * ({left});
spl1 = spl1 + {2.0 / n} * ({right});
"""


def hop_convolver(part: int = 1024, parts: int = 8) -> str:
    """A stereo-in, mono-convolved partitioned convolver in the hop
    regime.

    @init makes an impulse response of `part * parts` samples from a
    seeded formula (a decaying, sign-alternating tail), cuts it into
    `parts` partitions and keeps each one's spectrum (`fft_real` of the
    partition zero-padded to 2 * part, then `fft_permute`).  @sample
    writes the mid signal into an input block and reads the output ring;
    every `part` samples it calls `process()`, which copies the input
    block into a zero-padded buffer, transforms it, shifts a frequency
    -domain delay line of `parts` spectra, accumulates each partition's
    product with `convolve_c` against the delay line, transforms back and
    overlap-adds into the output ring @sample reads in the next `part`
    samples."""
    n, p = int(part), int(parts)
    return f"""\
desc:hop convolver (partitioned convolution fired every {n} samples)

@init
N = {n}; N2 = 2 * N; P = {p};
INB = 0; OUTR = N; OVL = 2 * N; WORK = 4 * N; ACC = 6 * N;
IRS = 8 * N; FDL = IRS + P * N2;
p = 0;
loop(P,
  memset(WORK, 0, N2);
  j = 0;
  loop(N,
    t = p * N + j;
    WORK[j] = exp(-t / 6000) * (((t * 7919) % 13) / 13 - 0.5) * 0.02;
    j += 1;
  );
  p == 0 ? WORK[0] = 1;
  fft_real(WORK, N2);
  fft_permute(WORK, N);
  memcpy(IRS + p * N2, WORK, N2);
  p += 1;
);
ctr = 0; rpos = 0;

function process() local(q, i) (
  memcpy(WORK, INB, N);
  memset(WORK + N, 0, N);
  fft_real(WORK, N2);
  fft_permute(WORK, N);
  q = P - 1;
  while (q > 0) (
    memcpy(FDL + q * N2, FDL + (q - 1) * N2, N2);
    q -= 1;
  );
  memcpy(FDL, WORK, N2);
  memset(ACC, 0, N2);
  q = 0;
  while (q < P) (
    memcpy(WORK, FDL + q * N2, N2);
    convolve_c(WORK, IRS + q * N2, N);
    i = 0;
    while (i < N2) ( ACC[i] += WORK[i]; i += 1; );
    q += 1;
  );
  fft_ipermute(ACC, N);
  ifft_real(ACC, N2);
  i = 0;
  while (i < N) (
    OUTR[i] = (ACC[i] + OVL[i]) / N2;
    OVL[i] = ACC[N + i];
    i += 1;
  );
  hops += 1;
);

@sample
y = OUTR[rpos];
INB[ctr] = 0.5 * (spl0 + spl1);
spl0 = 0.5 * spl0 + y;
spl1 = 0.5 * spl1 + y;
rpos += 1;
rpos >= N ? rpos = 0;
ctr += 1;
ctr >= N ? (
  process();
  ctr = 0;
);
"""


def grain_texture(grains: int = 16, ring: int = 131072) -> str:
    """A stereo granular texture, the stand-in for the catalog's Texture.

    @sample writes both input channels into two capture rings of `ring`
    cells (at 4,096 and 4,096 + ring, past the grain tables) and plays up
    to `grains` grains: a `loop(nact)` over the active grains, each
    grain's record (19 doubles, Texture's record width) found through an
    order table in memory (Texture's mem-value indirection), a linear
    ring read whose upper index is clamped by the block-rate fill level,
    `pos + 1 >= n ? n - 1 : floor(pos) + 1` (Texture's ctrl-bounded
    clamp), a sine window, a one-pole smoother and a pan.  A gate at
    |spl0| > 0.5 marks input onsets (at most one a 600 samples) and
    draws a rate jitter with rand() on every fourth gated sample.  @block
    drops the grains that ended from the order table and spawns a grain
    for each host note-on (`midirecv`, at most 8 a block) and for a marked
    onset, with rand() for its start, rate, length and pan.  On 0.25 rms
    noise the gate fires on about 4.6 % of the samples, so a 60 s render
    draws about 50,000 numbers.  `options: maxmem=33554432` is Texture's
    heap; the grain tables lie below 4,096 cells, so the executor's heap
    starts at 4,096 and climbs past the rings."""
    g, m = int(grains), int(ring)
    if not 1 <= g <= 200 or m < 128:
        raise ValueError(f"grains in [1, 200] and ring >= 128, not {g}, {m}")
    return f"""\
desc:grain texture (grain records, capture rings, rand in @block and @sample)
options:maxmem=33554432

@init
NG = {g}; RING = {m};
REC = 0; ORD = {19 * g}; SPN = ORD + NG;
RL = 4096; RR = RL + RING;
nact = 0; wpos = 0; wtotal = 0; nfill = 0;
cool = 0; onsets = 0; gc = 0; jit = 0; steal = 0; spawned = 0;
k = 0;
loop(NG,
  REC[k * 19] = 0;
  ORD[k] = k;
  k += 1;
);

@block
nfill = min(wtotal, RING);
k = 0; j = 0;
loop(nact,
  REC[ORD[j] * 19] > 0 ? ( ORD[k] = ORD[j]; k += 1; );
  j += 1;
);
nact = k;
ns = 0;
while (midirecv(ofs, m1, m2, m3)) (
  (m1 & 240) == 144 && m3 > 0 && ns < 8 ? ( SPN[ns] = m3 / 127; ns += 1; );
);
onsets > 0 && ns < 8 ? ( SPN[ns] = 0.5; ns += 1; );
onsets = 0;
j = 0;
loop(ns,
  nfill > 64 ? (
    slot = -1; q = 0;
    loop(NG, slot < 0 && REC[q * 19] <= 0 ? slot = q; q += 1; );
    slot < 0 ? ( slot = steal; steal = (steal + 1) % NG; )
             : ( ORD[nact] = slot; nact += 1; );
    r = REC + slot * 19;
    r[0] = 1;
    r[1] = rand(nfill - 2);
    r[2] = 0.5 + rand(3) * 0.5;
    r[3] = 1024 * (1 + floor(rand(8)));
    r[4] = 0;
    r[5] = SPN[j];
    r[6] = rand();
    r[7] = spawned & 1;
    r[8] = 0.05 + 0.9 * SPN[j];
    r[9] = 0; r[10] = 0;
    r[11] = spawned; r[12] = nfill; r[13] = slot; r[14] = j;
    r[15] = wpos; r[16] = ns; r[17] = nact; r[18] = steal;
    spawned += 1;
  );
  j += 1;
);

@sample
x0 = spl0; x1 = spl1;
RL[wpos] = x0; RR[wpos] = x1;
wpos += 1; wpos >= RING ? wpos = 0;
wtotal += 1;
abs(x0) > 0.5 ? (
  cool <= 0 ? ( onsets += 1; cool = 600; );
  gc += 1;
  (gc & 3) == 0 ? jit = (rand(2) - 1) * 0.001;
);
cool -= 1;
oL = 0; oR = 0; j = 0;
loop(nact,
  r = REC + ORD[j] * 19;
  r[0] > 0 ? (
    pos = r[1];
    base = r[7] > 0.5 ? RR : RL;
    i0 = floor(pos);
    i1 = pos + 1 >= nfill ? nfill - 1 : floor(pos) + 1;
    fr = pos - i0;
    s = base[i0] * (1 - fr) + base[i1] * fr;
    w = sin($pi * r[4] / r[3]);
    r[9] = r[9] + r[8] * (s * w - r[9]);
    v = r[9] * r[5];
    oL += v * (1 - r[6]);
    oR += v * r[6];
    pos += r[2] + jit;
    pos >= nfill ? pos -= nfill;
    r[1] = pos;
    r[4] += 1;
    r[4] >= r[3] ? r[0] = 0;
  );
  j += 1;
);
spl0 = 0.5 * x0 + 0.5 * oL;
spl1 = 0.5 * x1 + 0.5 * oR;
"""


def scene_voice_panner(voices: int = 8, scene: int = 256) -> str:
    """A voice panner linked to a scene manager, the stand-in for the
    catalog's 3DPanner (manager-linked via msg/gmem).

    @init takes its instance id, joins the bus inertly (`comm_join`,
    `msg_advertise`), attaches the "scene" segment and writes a scene of
    `scene` azimuths into gmem.  @block drains the manager's messages
    (`msg_recv` into out-params), copies the scene from gmem into a heap
    table that spans cell 4,096 (`gmem_get`), publishes its meters
    (`gmem_put` of a heap row, and a `gmem[]` store at its id's slot) and
    drifts one scene cell a block.  @sample follows the input's level and
    runs a voice loop whose count follows it (one to `voices` voices),
    each voice's record of 3 doubles (two pan gains smoothed toward the
    scene's azimuth, a head-shadow one-pole) written in the loop, over a
    delay ring of 1,024 cells; it reads the scene's cue at the level
    (`gmem[k]`, k dynamic).  The vectorizers reject the voice loop, and
    the sequential device executor (devexec, K11) renders it with gmem in
    its heap row's window.  A lone instance's bus delivers nothing, as in
    the golden."""
    v, n = int(voices), int(scene)
    if not 1 <= v <= 64 or not 8 <= n <= 4096 or n % 2:
        raise ValueError(f"voices in [1, 64] and an even scene in [8, 4096], "
                         f"not {v}, {n}")
    return f"""\
desc:scene voice panner (instance id, an inert bus, a gmem scene)
options:maxmem=65536

@init
NV = {v}; SC = {n};
VOX = 64; MET = 1000; RING = 2048; RN = 1024; TAB = {4096 - n // 2};
me = instance_id();
comm_join("scene");
msg_advertise("scene/obj", 1);
gmem_attach("scene");
k = 0;
loop(SC, gmem[k] = sin(k * 2.399963); k += 1; );
k = 0;
loop(NV, VOX[k * 3] = 0.5; VOX[k * 3 + 1] = 0.5; VOX[k * 3 + 2] = 0; k += 1; );
wp = 0; env = 0; bc = 0; nmsg = 0; peakL = 0; peakR = 0; nvmax = 0;

@block
while (msg_recv("scene/obj", src, tag, ma, mb, mc, md)) (
  nmsg += 1; TAB[tag % SC] = ma;
);
gmem_get(TAB, 0, SC);
MET[0] = peakL; MET[1] = peakR; MET[2] = nvmax; MET[3] = nmsg;
gmem_put(SC, MET, 4);
gmem[SC + 4 + me] = peakL + peakR;
c = bc % SC;
gmem[c] = gmem[c] * 0.99 + 0.01 * sin(bc * 0.37);
peakL = 0; peakR = 0; nvmax = 0; bc += 1;

@sample
lev = max(abs(spl0), abs(spl1));
env = lev > env ? lev : env * 0.9995;
nv = min(NV, 1 + floor(env * 2 * NV));
nv > nvmax ? nvmax = nv;
RING[wp] = 0.5 * (spl0 + spl1);
cue = gmem[floor(env * SC)];
oL = 0; oR = 0; k = 0;
loop(nv,
  r = VOX + k * 3;
  az = TAB[(k * 5 + bc) % SC];
  r[0] += 0.01 * (0.5 * (1 - az) - r[0]);
  r[1] += 0.01 * (0.5 * (1 + az) - r[1]);
  s = RING[(wp - 1 - k * 3 + RN) % RN];
  r[2] += 0.2 * (s - r[2]);
  oL += r[0] * r[2];
  oR += r[1] * r[2];
  k += 1;
);
wp += 1; wp >= RN ? wp = 0;
peakL = max(peakL, abs(oL)); peakR = max(peakR, abs(oR));
spl0 = 0.7 * spl0 + 0.3 * oL / NV + 0.001 * cue;
spl1 = 0.7 * spl1 + 0.3 * oR / NV + 0.001 * cue;
"""


def crossmix_declutter(slot: int = 0, n_slots: int = 4) -> str:
    """One instance of a cross-mix declutter session, for a render graph.

    @init attaches the gmem segment "declutter" and subscribes to the bus
    channel "meter".  @block, every block: takes the block's energy from
    the meters @sample accumulates, writes it to gmem[slot], reads the
    other slots in a loop and sets a ducking gain from the loudest,
    broadcasts its energy on "meter" and drains its queue with
    `while (msg_recv(...))`, counting what it hears and keeping the last
    value.  @sample sums the energy, smooths the gain with a one-pole
    and delays each channel by 64 samples of lookahead, smeared by two
    later taps (80 and 96 samples; a 128-cell ring each)."""
    return f"""\
desc:crossmix declutter (gmem slots, meter bus, coupled @block)

@init
gmem_attach("declutter");
msg_subscribe("meter");
SLOT = {int(slot)}; NS = {int(n_slots)};
MASK = 127; RL = 0; RR = 128; LOOK = 64;
duck = 1; g = 1; heard = 0; last = 0; lsrc = 0;

@block
e = (e0 + e1) / max(2 * samplesblock, 1);
e0 = 0; e1 = 0;
gmem[SLOT] = e;
loud = 0; i = 0;
loop(NS, i != SLOT ? loud = max(loud, gmem[i]); i += 1;);
duck = 1 / (1 + 8 * sqrt(loud));
msg_send("meter", SLOT, e, loud, 0, 0);
while (msg_recv("meter", src, tg, pa, pb, pc, pd)) (
  heard += 1; last = pa; lsrc = src;
);

@sample
e0 += spl0 * spl0;
e1 += spl1 * spl1;
g += 0.01 * (duck - g);
RL[wp & MASK] = spl0;
RR[wp & MASK] = spl1;
dl = 0.6 * RL[(wp - LOOK) & MASK] + 0.25 * RL[(wp - 80) & MASK] + 0.15 * RL[(wp - 96) & MASK];
dr = 0.6 * RR[(wp - LOOK) & MASK] + 0.25 * RR[(wp - 80) & MASK] + 0.15 * RR[(wp - 96) & MASK];
spl0 = g * dl;
spl1 = g * dr;
wp += 1;
"""


def pool_sampler(voices: int = 8, samples: int = 16) -> str:
    """A stereo sampler over the sample pool, the stand-in for the
    catalog's Sample.

    @init builds the pool from file slot 0 (`sample_pool_from_slot`,
    `sample_pool_commit`: the host resamples every entry to the engine's
    rate) and gives each of `voices` voices a record of 6 doubles at
    mem[0] (sample id, phase, step, gain, pan, frames), voice k on entry k
    of the `samples` the slot holds, stepping at (0.5 + 0.125 k) x its
    entry's rate over the engine's (`sample_srate`).  @sample reads each
    voice with `sample_read2_interp` at its phase (voice 0 also one
    `sample_read_interp` at half its phase), pans it into the mix, and at
    an entry's end retriggers the voice on the next entry in turn: a
    traced `sample_get(pool, k)` and `sample_len`, so a 60 s render of
    10 s entries reads every entry.  The traced sample ids make it a
    vectorizer reject that the sequential executor (K11) renders."""
    nv, ns = int(voices), int(samples)
    if not 1 <= nv <= 64 or ns < 1:
        raise ValueError(f"voices in [1, 64] and samples >= 1, not {nv}, {ns}")
    return f"""\
desc:pool sampler ({nv} voices over the sample pool of slot 0)

@init
NV = {nv}; NS = {ns}; VREC = 0;
pool = sample_pool_from_slot(0, "sampler");
sample_pool_commit(pool);
nload = sample_pool_loaded(pool);
vi = 0;
loop(NV,
  rec = VREC + vi * 6;
  rec[0] = sample_get(pool, vi % max(nload, 1));
  rec[1] = 0;
  rec[2] = (0.5 + 0.125 * vi) * sample_srate(pool, rec[0]) / srate;
  rec[3] = 0.5 / NV;
  rec[4] = vi / max(NV - 1, 1);
  rec[5] = sample_len(pool, rec[0]);
  vi += 1;
);
trig = NV;

@sample
outl = 0; outr = 0; vi = 0;
loop(NV,
  rec = VREC + vi * 6;
  sid = rec[0]; ph = rec[1];
  sample_read2_interp(pool, sid, ph, vl, vr);
  vi == 0 ? vl = 0.5 * (vl + sample_read_interp(pool, sid, 0, ph * 0.5));
  outl += vl * rec[3] * (1 - rec[4]);
  outr += vr * rec[3] * rec[4];
  ph += rec[2];
  ph >= rec[5] - 1 ? (
    sid = sample_get(pool, trig % max(nload, 1));
    trig += 1;
    rec[0] = sid;
    rec[2] = (0.5 + 0.125 * vi) * sample_srate(pool, sid) / srate;
    rec[5] = sample_len(pool, sid);
    ph = 0;
  );
  rec[1] = ph;
  vi += 1;
);
spl0 = spl0 * 0.25 + outl;
spl1 = spl1 * 0.25 + outr;
"""


def sampler_slot(samples: int = 16, seconds: float = 10.0,
                 seed: int = 0) -> List[Tuple[np.ndarray, float]]:
    """File slot 0 of `pool_sampler`: `samples` stereo entries of
    `seconds` made from the seed (decaying noise bursts over a tone), as
    (audio [2, frames] float64, rate); one in four at 44,100 Hz, the rest
    at 48,000 Hz."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(int(samples)):
        rate = 44100.0 if k % 4 == 3 else 48000.0
        n = int(round(seconds * rate))
        t = np.arange(n) / rate
        tone = 0.3 * np.sin(2 * np.pi * (110.0 * (1 + k % 5)) * t)
        env = np.exp(-3.0 * (t % 1.0))
        audio = np.stack([tone + 0.2 * env * rng.randn(n),
                          tone * 0.8 + 0.2 * env * rng.randn(n)])
        out.append((audio, rate))
    return out


def slot_table_leveler(frames: int = 65536) -> str:
    """A leveler that loads a table from file slot 0 in @block, the
    stand-in for the catalog's PsychoConvolver `load_raw_ir`.

    @block levels by the meter @sample accumulates and, under a reload
    flag set at the first block and every 2,048 blocks after, loads the
    slot's first `frames` values into mem[0 ...]: `file_open`,
    `file_riff`, `file_avail`, `file_mem`, `file_close`.  @sample reads
    the table through a cursor masked to `frames` (a power of two) and
    mixes it in.
    The meter makes the @block audio-coupled: K10 runs it, and the load
    folds into its text as a copy from the file table."""
    n = int(frames)
    if n < 16 or n & (n - 1):
        raise ValueError(f"frames a power of two >= 16, not {n}")
    return f"""\
desc:slot table leveler (a {n}-value table loaded from slot 0 in @block)

@init
N = {n}; TAB = 0; MASK = N - 1; HALF = {n // 2};
need = 1; loaded = 0; rp = 0; g = 1; acc = 0; blocks = 0;

@block
g = 1 / (1 + 4 * acc / max(samplesblock, 1));
acc = 0;
blocks += 1;
blocks % 2048 == 1 ? need = 1;
need ? (
  h = file_open(0);
  h > 0 ? (
    nch = 0; sr = 0;
    file_riff(h, nch, sr);
    n = min(file_avail(h), N);
    file_mem(h, TAB, n);
    loaded = n;
    file_close(h);
  );
  need = 0;
);

@sample
acc += abs(spl0);
spl0 = spl0 * g + 0.05 * TAB[rp & MASK];
spl1 = spl1 * g + 0.05 * TAB[(rp + HALF) & MASK];
rp += 1;
"""


def table_slot(frames: int = 65536, seed: int = 0) -> np.ndarray:
    """File slot 0 of `slot_table_leveler`: a mono table of `frames`
    values made from the seed (a decaying noise response), [1, frames]."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(frames), dtype=np.float64)
    return (rng.randn(int(frames)) * np.exp(-t / (frames / 6.0)))[None, :]


def modulated_delay_chorus(voices: int = 3, buf: int = 4096) -> str:
    """A stereo chorus of `voices` voices over two rings of `buf` cells.

    Each voice's delay is `buf / 8 + i * buf / 16` cells, moved by
    `buf / 16` cells by a sine LFO of its own rate and phase (the sample
    counter `w` is its clock), so the read slot changes every sample.  A
    voice reads each ring twice, at the delay's whole part and one cell
    further, and interpolates linearly by its fraction; the voices are
    panned across the channels.  The delays stay below `buf`, so no read
    reaches the sample's own write."""
    v, m = int(voices), int(buf)
    reads = []
    for i in range(v):
        base, depth = m // 8 + i * (m // 16), m // 16
        rate = 2 * np.pi * (0.23 + 0.17 * i) / 48000.0
        reads.append(
            f"d{i} = {base} + {depth} * sin(w * {rate!r} + {0.9 * i!r});\n"
            f"k{i} = floor(d{i}); f{i} = d{i} - k{i};\n"
            f"a{i} = mem[(w - k{i}) & MASK];\n"
            f"b{i} = mem[(w - k{i} - 1) & MASK];\n"
            f"c{i} = mem[{m} + ((w - k{i}) & MASK)];\n"
            f"e{i} = mem[{m} + ((w - k{i} - 1) & MASK)];\n"
            f"vl{i} = a{i} + f{i} * (b{i} - a{i});\n"
            f"vr{i} = c{i} + f{i} * (e{i} - c{i});")
    pan = [(i + 0.5) / v for i in range(v)]
    left = " + ".join(f"{1.0 - p!r} * vl{i}" for i, p in enumerate(pan))
    right = " + ".join(f"{p!r} * vr{i}" for i, p in enumerate(pan))
    body = "\n".join(reads)
    return f"""\
desc:modulated delay chorus (per-voice sine LFOs, dynamic ring reads)

@init
MASK = {m - 1};
w = 0;

@sample
mem[w & MASK] = spl0;
mem[{m} + (w & MASK)] = spl1;
{body}
spl0 = 0.6 * spl0 + {0.8 / v!r} * ({left});
spl1 = 0.6 * spl1 + {0.8 / v!r} * ({right});
w += 1;
"""


def tpdf_dither(bits: int = 16) -> str:
    """Triangular (TPDF) dither, then quantisation to `bits` bits: each
    channel adds `(rand(1) - rand(1))` steps of the quantiser and rounds
    to the step, four ungated rand() draws a sample."""
    return f"""\
desc:TPDF dither to {int(bits)} bits (ungated rand, 4 draws a sample)

@init
q = {1.0 / (1 << (int(bits) - 1))!r};

@sample
dl = (rand(1) - rand(1)) * q;
dr = (rand(1) - rand(1)) * q;
spl0 = floor((spl0 + dl) / q + 0.5) * q;
spl1 = floor((spl1 + dr) / q + 0.5) * q;
"""
