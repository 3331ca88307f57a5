"""The port's ``kill-and-heal`` on the lane and coalescer surfaces, held to
the reference's own runs (``tests/test_chaos_soak.py``'s inputs): the same
seed and kill through both packages' harnesses, every survivor's replay
lines equal across the two (but one, below).
"""

import pytest

from rocnrdma_tpu import native as RN
from rocnrdma_tpu_torch import native as PN

from test_torch_chaos_heal import variants_held

pytestmark = [
    pytest.mark.chaos,
    pytest.mark.skipif(not (RN.available() and PN.available()),
                       reason="native rqp library not buildable"),
]


# FLEET digests the resumed-frame count too. Under --lanes the port's
# survivors 0 and 1 resume one frame where the reference's resume two: a
# send's progress tests the posted receives (the port's fix of the arena
# credit starvation, ROADMAP Queue 3), so one ping had already landed and
# been consumed when the kill fell. Both packages replay it per seed.
VARIANTS = {"lanes": ({"lanes": True}, "49", ("LANEFENCED",)),
            "coalesce": ({"coalesce": True}, "49", ("COALESCED", "TRACELOG", "FLEET"))}


@pytest.fixture(scope="module")
def held():
    """Each variant's outcome (None, or the exception its check raised):
    the variants' fleets run at once (their processes, stores and
    segments are their own), each held as the helper holds it."""
    return variants_held(VARIANTS)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kill_and_heal_variant_equals_the_references(held, variant):
    if held[variant] is not None:
        raise held[variant]
