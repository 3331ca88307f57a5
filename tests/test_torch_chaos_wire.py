"""The port's ``kill-and-heal`` on the int8 codec lane and on the
hierarchical schedule with a node leader killed, held to the reference's
own runs (``tests/test_codec.py``'s and ``tests/test_hier.py``'s inputs):
the same seed and kill through both packages' harnesses, every survivor's
replay lines equal across the two.
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


VARIANTS = {"codec": ({"codec": "int8"}, "49", ("CODECLOG", "FLEET")),
            "hier": ({"hier": True}, "35", ("TRACELOG", "FLEET"))}


@pytest.fixture(scope="module")
def held():
    """Each variant's outcome (None, or the exception its check raised),
    the variants' fleets run at once (``test_torch_chaos_variants.py``)."""
    return variants_held(VARIANTS)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kill_and_heal_wire_variant_equals_the_references(held, variant):
    if held[variant] is not None:
        raise held[variant]
