"""JSFX plugins that ship with the package.

`FALLBACK_SRC` is the in-repo plugin shaped like the catalog's DDT delay
network: a stereo ring delay network with 16 taps a channel, two
one-pole recurrences and an induction cursor (the same text as the JAX
package's entry script carries).  `wide_delay_network(n_taps)` is the
same network at a catalog plugin's scale: its own tap tables, a larger
ring and delays spread over most of it.  `cross_fed_delay_network` feeds
the right ring from the left tap sum, so the right sum depends on the
left one within a sample.
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
