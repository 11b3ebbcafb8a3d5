"""Two faults of the reference's ``ServingEngine`` with a model, which the
port mirrors on purpose (ROADMAP.md queue C items 3 and 4), pinned token
for token in both packages on one set of smoke parameters.

* Item 3: a single-slot prefill decodes every row, then takes back only
  ``len``; a recurrent state cannot be taken back, so the xlstm smoke
  model's request A gives other tokens when request B is prefilled
  beside it (``max_batch`` 2).
* Item 4: a slot keeps whatever cache its last request left, and every
  tick advances a free slot's ``len`` too; so the gemma smoke model's
  request A gives other tokens when it runs after request B in the same
  slot (``max_batch`` 1).

Neither package fixes either fault: the tokens below are the reference's,
and the port's must be the same.
"""

import torch_parity  # noqa: F401

import pytest
import torch

from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.serving.engine import ServingEngine
from torch_parity import model_pair

A = list(range(12))
B = list(range(12, 24))
NEW_TOKENS = 6

#: case -> (arch, max_batch, prompts in submission order, the index of
#: request A among them, A's tokens)
CASES = {
    "xlstm A alone": ("xlstm-1.3b", 2, [A], 0,
                      [368, 166, 487, 260, 123, 110]),
    "xlstm A beside B": ("xlstm-1.3b", 2, [A, B], 0,
                         [302, 500, 362, 145, 273, 190]),
    "gemma A alone": ("gemma-2b", 1, [A], 0,
                      [499, 176, 499, 499, 499, 176]),
    "gemma A after B": ("gemma-2b", 1, [B, A], 1,
                        [344, 28, 487, 376, 344, 376]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tokens_of_a(package: str, case: str):
    arch, max_batch, prompts, index, _ = CASES[case]
    rm, rp, tm, tp = model_pair(arch)
    eng = (RefEngine(rm, rp, max_batch=max_batch, max_seq=64)
           if package == "reference" else
           ServingEngine(tm, tp, max_batch=max_batch, max_seq=64,
                         device="cpu"))
    for prompt in prompts:
        eng.submit(prompt, max_new_tokens=NEW_TOKENS)
    done = {r.req_id: list(r.generated) for r in eng.run_until_idle()}
    return done[index]


@pytest.mark.parametrize("package", ["reference", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_fault_is_pinned(package, case):
    """Request A's greedy tokens in each setting are the pinned ones."""
    assert tokens_of_a(package, case) == CASES[case][4]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "gemma-2b"])
def test_pinned_settings_differ(arch):
    """Each fault shows: request A's pinned tokens differ between its two
    settings."""
    runs = [v[4] for v in CASES.values() if v[0] == arch]
    assert len(runs) == 2 and runs[0] != runs[1]
