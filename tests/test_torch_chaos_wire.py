"""The port's ``kill-and-heal`` on the int8 codec lane and on the
hierarchical schedule with a node leader killed, held to the reference's
own runs (``tests/test_codec.py``'s and ``tests/test_hier.py``'s inputs):
the same seed and kill through both packages' harnesses, every survivor's
replay lines equal across the two.
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


@pytest.mark.parametrize("variant,kill_op,lines", [
    ({"codec": "int8"}, "49", ("CODECLOG", "FLEET")),
    ({"hier": True}, "35", ("TRACELOG", "FLEET")),
], ids=["codec", "hier"])
def test_kill_and_heal_wire_variant_equals_the_references(monkeypatch, variant,
                                                          kill_op, lines):
    variant_equals_reference(monkeypatch, variant, kill_op, lines)
