"""The port's ``kill-and-heal`` on the lane and coalescer surfaces, held to
the reference's own runs (``tests/test_chaos_soak.py``'s inputs): the same
seed and kill through both packages' harnesses, every survivor's replay
lines equal across the two (but one, below).
"""

import pytest

from rocnrdma_tpu import native as RN
from rocnrdma_tpu_torch import native as PN

from _chaos import variant_equals_reference

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
@pytest.mark.parametrize("variant,lines", [
    ({"lanes": True}, ("LANEFENCED",)),
    ({"coalesce": True}, ("COALESCED", "TRACELOG", "FLEET")),
], ids=["lanes", "coalesce"])
def test_kill_and_heal_variant_equals_the_references(monkeypatch, variant, lines):
    variant_equals_reference(monkeypatch, variant, "49", lines)
