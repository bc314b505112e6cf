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
"""
from __future__ import annotations

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
