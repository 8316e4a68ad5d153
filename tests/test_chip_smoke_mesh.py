"""chip_smoke.py --four-cards on the CPU: the mesh build and sharded
queries over 4 of the 8 virtual devices, at a tiny corpus size."""

import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def test_four_cards_phase():
    assert len(jax.devices()) >= 4
    times = cs.run_four_cards(0.125, 0, 256)
    assert "mesh regex+boolean[vrle]" in times
