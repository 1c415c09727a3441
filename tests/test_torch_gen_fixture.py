"""The generator fixture of the torch port: abcnet_tpu_torch/assets/gen_digests.npz.

`chip_smoke.py` checks on the GPU machine's host that the port's
generator makes the JAX package's data. The images of engine A depend on
the Pillow and FreeType builds that draw the labels, so the fixture
keeps digests (sha256, 32 raw bytes each), made here by the JAX package:

  modes, engines, seeds      the nine (mode, engine) streams, mode in
                             {rdkit, indigo, mixed} x engine in {a, b,
                             mix}, each random.Random(seed)
  image, atoms, bonds,       per stream, digests of its first N_PER_STREAM
  smiles                     accepted samples: the image bytes, the label
                             strings, the truth SMILES; (9, N, 32) uint8
  attempts                   generate_sample calls each stream took
  rng                        digest of repr(rng.getstate()) after them
  corpus                     stereo SMILES rendered in the given-corpus
                             mode, one random.Random(CORPUS_SEED) through
                             the list (mode mixed, engine a)
  corpus_image, corpus_atoms,  digests per entry (of b"" where it was
  corpus_bonds, corpus_smiles  rejected)
  corpus_truth               the truth SMILES of each entry

Rebuild (a few seconds of CPU):

    env JAX_PLATFORMS=cpu python tests/test_torch_gen_fixture.py [out.npz]
"""

import hashlib
import os
import random
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                       "gen_digests.npz")
N_PER_STREAM = 16
STREAMS = tuple((mode, engine, 1000 + 10 * i + j)
                for i, mode in enumerate(("rdkit", "indigo", "mixed"))
                for j, engine in enumerate(("a", "b", "mix")))
CORPUS_SEED = 31
CORPUS = ("C[C@H](N)C(=O)O", "C[C@@H](O)CC(=O)O", "F/C=C/F", "Cl/C=C\\Cl",
          "O[C@H]1CC[C@@H](N)CC1", "C[C@](F)(Cl)Br",
          "N[C@@H](Cc1ccccc1)C(=O)O", "C/C=C/C(=O)O[C@@H]1CCCC[C@H]1C",
          "c1ccc2ccccc2c1", "O=C(O)c1ccccc1OC(C)=O")


def sha256(b: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(b).digest(), np.uint8)


def sample_digests(s):
    """(image, atoms, bonds, smiles) digests of a Sample (of b"" for
    None)."""
    if s is None:
        return [sha256(b"")] * 4
    return [sha256(np.ascontiguousarray(s.image).tobytes()),
            sha256(s.atoms_string.encode()), sha256(s.bonds_string.encode()),
            sha256(s.smiles.encode())]


def stream_digests(generate_sample, mode, engine, seed, n=N_PER_STREAM):
    """(digests (4, n, 32), attempts, rng digest) of the first n accepted
    samples of one stream."""
    rng = random.Random(seed)
    digests, attempts = [], 0
    while len(digests) < n:
        s = generate_sample(rng, mode=mode, engine=engine)
        attempts += 1
        if s is not None:
            digests.append(sample_digests(s))
    return (np.stack(digests, axis=1), attempts,
            sha256(repr(rng.getstate()).encode()))


def corpus_samples(generate_sample, corpus=CORPUS):
    rng = random.Random(CORPUS_SEED)
    return [generate_sample(rng, smiles=smi) for smi in corpus]


FIELDS = ("image", "atoms", "bonds", "smiles")


def build(generate_sample, n=N_PER_STREAM, corpus=CORPUS):
    streams = [stream_digests(generate_sample, m, e, s, n)
               for m, e, s in STREAMS]
    digests = np.stack([d for d, _, _ in streams], axis=1)   # (4, 9, n, 32)
    found = corpus_samples(generate_sample, corpus)
    cdig = np.stack([sample_digests(s) for s in found], axis=1)
    return {
        "modes": np.array([m for m, _, _ in STREAMS]),
        "engines": np.array([e for _, e, _ in STREAMS]),
        "seeds": np.array([s for _, _, s in STREAMS], np.int64),
        **dict(zip(FIELDS, digests)),
        "attempts": np.array([a for _, a, _ in streams], np.int64),
        "rng": np.stack([r for _, _, r in streams]),
        "corpus": np.array(corpus),
        **{f"corpus_{k}": v for k, v in zip(FIELDS, cdig)},
        "corpus_truth": np.array(["" if s is None else s.smiles
                                  for s in found]),
    }


def build_fixture(out_path: str) -> None:
    from abcnet_tpu.data.generate import generate_sample
    np.savez_compressed(out_path, **build(generate_sample))


def test_fixture_rebuilds_at_small_n():
    """The committed digests are the JAX package's: a fresh build of the
    first 2 samples of every stream and the first 3 corpus entries."""
    from abcnet_tpu.data.generate import generate_sample

    z = np.load(FIXTURE)
    fresh = build(generate_sample, n=2, corpus=CORPUS[:3])
    for k in ("modes", "engines", "seeds"):
        np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
    for k in FIELDS:
        np.testing.assert_array_equal(z[k][:, :2], fresh[k], err_msg=k)
        np.testing.assert_array_equal(z[f"corpus_{k}"][:3],
                                      fresh[f"corpus_{k}"], err_msg=k)
    np.testing.assert_array_equal(z["corpus_truth"][:3],
                                  fresh["corpus_truth"])
    assert z["image"].shape == (9, N_PER_STREAM, 32)
    assert z["corpus"].tolist() == list(CORPUS)
    # every corpus entry renders, and the stereo ones keep their stereo
    assert all(z["corpus_truth"])
    assert sum(("@" in s) or ("/" in s) or ("\\" in s)
               for s in z["corpus_truth"]) >= 7
    assert os.path.getsize(FIXTURE) < 64 * 2 ** 10


def test_port_generator_matches_digests():
    """The port's generator against every digest of the fixture: images,
    label strings, SMILES, attempts and the rng state after each stream."""
    from abcnet_tpu_torch.data.generate import generate_sample

    z = np.load(FIXTURE)
    got = build(generate_sample, n=z["image"].shape[1],
                corpus=tuple(z["corpus"].tolist()))
    for k in z.files:
        np.testing.assert_array_equal(z[k], got[k], err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    build_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
    print(f"wrote {sys.argv[1] if len(sys.argv) > 1 else FIXTURE}")
