"""unlaundered-restore-placement, torch profile: zero-copy tensor views
of restored arrays (the fit's in-place writes would write through)."""
import pickle

import numpy as np
import torch


def load_params(path):
    with np.load(path) as z:
        w = torch.from_numpy(z["W"])  # EXPECT
    return w


def load_state(blob):
    arr = np.frombuffer(blob, dtype=np.float32)
    return torch.as_tensor(arr.reshape(2, -1))  # EXPECT


def load_pickle(fh):
    state = pickle.load(fh)
    view = np.asarray(state)
    return torch.asarray(view)  # EXPECT


class Restorer:
    def restore(self, path):
        self.raw = np.load(path)
        self.params = torch.from_numpy(self.raw)  # EXPECT
