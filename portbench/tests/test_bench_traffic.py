"""The traffic generator: deterministic from the seed, the same sizes for
every seed, every listed bucket filled, the port's bucket and decode-length
rules."""

import collections

import numpy as np
import pytest

from portbench import traffic
from portbench.harness import load_json

from .conftest import tiny_config, tiny_mix


def _shapes(pool):
    return collections.Counter(hb.shape_key() for hb in pool)


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_same_seed_same_pool_other_seed_same_sizes(entry):
    cfg, mix = tiny_config(), tiny_mix(entry)
    a = traffic.build_pool(mix, cfg, 2 ** 31 + 7, train=entry == "train")
    b = traffic.build_pool(mix, cfg, 2 ** 31 + 7, train=entry == "train")
    c = traffic.build_pool(mix, cfg, 11, train=entry == "train")
    for x, y in zip(a, b):
        assert np.array_equal(x.audio, y.audio) and x.index == y.index
        if entry == "train":
            assert np.array_equal(x.targets_out, y.targets_out)
    assert _shapes(a) == _shapes(c)
    assert sorted(hb.seconds for hb in a) == pytest.approx(sorted(hb.seconds for hb in c))
    assert [hb.index for hb in a] != [hb.index for hb in c] or not np.array_equal(
        a[0].audio, c[0].audio)


def test_rows_all_differ():
    pool = traffic.build_pool(tiny_mix("train"), tiny_config(), 5, train=True)
    rows = [hb.audio[r, :hb.sample_lens[r]].tobytes() for hb in pool
            for r in range(hb.audio.shape[0])]
    assert len(set(rows)) == len(rows)


def test_every_listed_bucket_gets_its_batches_by_the_port_rule():
    from speech_tranformer_pytorch_tpu_torch.config import FeatureConfig
    from speech_tranformer_pytorch_tpu_torch.data.pipeline import (_bucket_of,
                                                                    _frames_for_samples)

    cfg = load_json("configs", "base.json")["config"]
    m = load_json("mixes", "serve.aishell-b8.json")
    bnd = cfg["data"]["bucket_boundaries"]
    fc = FeatureConfig()
    batches = traffic.draw_batches(m, bnd, cfg["features"])
    spec = m["lengths"]
    assert collections.Counter(bnd[b] for b, _ in batches) == {
        b: spec["batches_per_bucket"] for b in spec["buckets"]}
    for b, lens in batches:
        assert len(lens) == m["batch"]
        assert lens.min() >= spec["min_s"] * 16000 - 160
        for n in lens:
            frames = _frames_for_samples(int(n), fc)
            assert 0 < frames <= cfg["data"]["max_source_frames"]
            assert _bucket_of(frames, bnd) == b
    # lengths spread over each bucket's range
    assert max(n.max() for _, n in batches) / 16000 > bnd[batches[-1][0]] / 100 - 0.5


def test_decode_length_follows_the_port_rule():
    cfg = load_json("configs", "base.json")["config"]
    mix = load_json("mixes", "serve.aishell-b8.json")
    pool = traffic.build_pool(mix, cfg, 1, train=False)
    # recognize.decode_manifest: max(4, min(max_len, int(ratio * encoder frames)))
    want = {200: 6, 400: 12, 600: 19, 800: 25, 1000: 31, 1400: 44}
    assert {hb.bucket: hb.max_len for hb in pool} == want
