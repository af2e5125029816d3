"""The port's constants, BIN table and hseg cascade tables equal the JAX
package's."""

import numpy as np
import pytest

import cardio_dmz_tpu.constants as jc
import cardio_dmz_tpu_torch.constants as pc
from cardio_dmz_tpu.scan import hseg as jhseg
from cardio_dmz_tpu.utils import olm as jolm
from cardio_dmz_tpu_torch.scan import hseg as phseg
from cardio_dmz_tpu_torch.utils import olm as polm


def _public(mod):
    return sorted(n for n in vars(mod) if n.isupper())


@pytest.mark.parametrize("name", _public(jc))
def test_constant_equal(name):
    assert getattr(pc, name) == getattr(jc, name)


def test_same_public_names():
    assert _public(pc) == _public(jc)


def test_card_table_equal():
    def rows(table):
        return [(int(i.card_type), i.number_length, i.prefix_length,
                 i.min_prefix, i.max_prefix) for i in table]
    assert rows(polm.CARD_TABLE) == rows(jolm.CARD_TABLE)


_TOP = ("wval", "u1", "v2", "v3", "v4", "fu2", "fu3", "fu4")
_PER_PATTERN = ("bank", "base1", "base2", "base3", "base4",
                "ob1", "ob2", "ob3", "ob4")


@pytest.mark.parametrize("key", list(_TOP) + [
    f"{p}/{k}" for p in ("visa", "amex") for k in _PER_PATTERN])
def test_cascade_table_equal(key):
    def get(tables):
        for part in key.split("/"):
            tables = tables[part]
        return tables
    ref = get(jhseg._cascade_tables())
    got = get(phseg._cascade_tables())
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
