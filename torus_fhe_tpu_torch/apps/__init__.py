"""Applications over the circuits: encrypted KNN (single key and 3gen
multikey, with the threshold-decryption tail), CNN layers and volume
matching. Port of torus_fhe_tpu/apps/."""

from . import cnn, knn, mk_knn, volume_matching
