"""The engines' descriptions say what the card runs: since the block-chain
kernels were redesigned, ``fused_pipe`` and ``fused_tiered`` run K1's draw,
K4a's two block sorts and one persistent launch with the rows updated in
place (``kernels/sgns_fused_pipe.py: chain_step``); no ring and no block
planner run on the card."""

import pytest

from repro_torch.core import engine
from repro_torch.kernels import sgns_fused_pipe

STALE = ("staged through a ring", "ring of slots", "hazard-ordered", "through the ring",
         "gathers its unique rows once into a ring slot")


@pytest.mark.parametrize("doc", ("module", "FusedPipeEngine", "FusedTieredEngine"))
def test_engine_docs_describe_the_card_path(doc):
    text = " ".join((engine.__doc__ if doc == "module" else getattr(engine, doc).__doc__)
                    .split())
    for phrase in STALE:
        assert phrase not in text, phrase
    assert "in place" in text


def test_the_card_path_is_what_the_docs_name():
    text = " ".join(sgns_fused_pipe.chain_step.__doc__.split())
    assert "K4a's two block sorts" in text and "run_chain" in text
    assert "chain_step" in " ".join(engine.__doc__.split())
