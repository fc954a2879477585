"""The frozen generator draws what the program's generator draws."""

import numpy as np
import pytest

from benchmark import synthetic
from kgat_tpu_torch.data import synthetic_dataset

SIZES = dict(n_users=150, n_items=120, n_entities=260, n_relations_kg=6,
             n_interactions=2500, n_triples=1800)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_frozen_generator_equals_the_programs(seed):
    got = synthetic.generate(seed=seed, **SIZES)
    want = synthetic_dataset(seed=seed, **SIZES)
    np.testing.assert_array_equal(got["cf_train"], want.cf_train)
    np.testing.assert_array_equal(got["cf_test"], want.cf_test)
    np.testing.assert_array_equal(got["kg_triples"], want.kg_triples)
