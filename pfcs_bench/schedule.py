"""What the engine was asked to do, worked out by the benchmark itself from
the requests it submitted, the engine's documented tick and the tokens the
engine served.

``ServingEngine.step()``: (1) every free slot, lowest index first, takes
the oldest queued request, whose prompt is registered with the page tier
and prefilled one token a model call: the call feeds that token to the
slot's row and 0 to every other row, and only that row's cache length
advances; (2) the live slots' pages are touched (the last
``reread_window`` pages of each chain, slot order), and one model call
feeds each live row its last served token (the prompt's last token
before any), 0 to free rows, advancing every row; each live request takes
the greedy token its row produced; (3) a request that reached its length
is released and its slot freed.

Per model call the mirror keeps the token column, which rows advanced,
and the token each row served (-1: none).  It checks, after every tick,
that the engine's slots hold the requests it expects.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Mirror:
    def __init__(self, max_batch: int):
        self.b = max_batch
        self.queue: List[int] = []                     # request ids
        self.req: Dict[int, Dict] = {}
        self.slots: List[Optional[int]] = [None] * max_batch
        self.tokens: List[np.ndarray] = []             # per call (B,)
        self.adv: List[np.ndarray] = []
        self.served: List[np.ndarray] = []
        self.kind: List[str] = []                      # "prefill" | "tick"
        self.steps: List[Dict] = []                    # per step() call
        self.mismatch = 0

    def submit(self, eng_req, t: float) -> None:
        """``eng_req``: the engine's ``Request`` just queued (its
        ``generated`` list is where the served tokens appear)."""
        rid = eng_req.req_id
        self.queue.append(rid)
        self.req[rid] = {"prompt": list(eng_req.prompt),
                         "max_new": int(eng_req.max_new_tokens),
                         "submit_t": t, "token_t": [], "served": [],
                         "slot": None, "eng_req": eng_req}

    def _call(self, tok: Dict[int, int], adv, kind: str) -> int:
        col = np.zeros(self.b, np.int64)
        for i, t in tok.items():
            col[i] = t
        a = np.zeros(self.b, bool)
        a[list(adv)] = True
        self.tokens.append(col)
        self.adv.append(a)
        self.served.append(np.full(self.b, -1, np.int64))
        self.kind.append(kind)
        return len(self.tokens) - 1

    def step(self, eng_step) -> Dict:
        """Mirror one ``step()``, run it (``eng_step()`` returns the request
        id in each of the engine's slots after it, None for a free one, and
        the time), and read the served tokens."""
        first = len(self.tokens)
        admitted = []
        for i in range(self.b):
            if self.slots[i] is None and self.queue:
                rid = self.queue.pop(0)
                self.slots[i] = rid
                self.req[rid]["slot"] = i
                admitted.append(rid)
                for tok in self.req[rid]["prompt"]:
                    self._call({i: tok}, [i], "prefill")
        live = [(i, rid) for i, rid in enumerate(self.slots)
                if rid is not None]
        touches = list(live)
        col = {}
        for i, rid in live:
            r = self.req[rid]
            col[i] = r["served"][-1] if r["served"] else r["prompt"][-1]
        tick = self._call(col, range(self.b), "tick") if live else None
        after, t = eng_step()
        done = []
        for i, rid in live:
            r = self.req[rid]
            gen = r["eng_req"].generated
            if len(gen) != len(r["served"]) + 1:
                self.mismatch += 1
                continue
            r["served"].append(int(gen[-1]))
            r["token_t"].append(t)
            self.served[tick][i] = int(gen[-1])
            if len(r["served"]) >= r["max_new"]:
                done.append(rid)
                self.slots[i] = None
        for i in range(self.b):
            if self.slots[i] != after[i]:
                self.mismatch += 1
        rec = {"t": t, "calls": (first, len(self.tokens)),
               "admitted": admitted, "touches": touches, "done": done,
               "tick": tick}
        self.steps.append(rec)
        return rec

    # ------------------------------------------------------------------ #

    def arrays(self):
        """(tokens (C, B), adv (C, B), served (C, B)) over every call."""
        return (np.stack(self.tokens), np.stack(self.adv),
                np.stack(self.served))

    def lens(self) -> np.ndarray:
        """(C, B): each row's cache length before each call."""
        adv = np.stack(self.adv)
        return np.cumsum(adv, 0) - adv
