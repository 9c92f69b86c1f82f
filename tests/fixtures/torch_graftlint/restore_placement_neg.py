"""unlaundered-restore-placement near-misses, torch profile: restored
arrays copied before the view, and views of data that was never
restored."""
import numpy as np
import torch


def load_params(path):
    with np.load(path) as z:
        w = torch.from_numpy(np.array(z["W"]))
        b = torch.from_numpy(z["b"]).clone()
        c = torch.tensor(z["c"])
    return w, b, c


def load_state(blob):
    arr = np.frombuffer(blob, dtype=np.float32).copy()
    return torch.as_tensor(arr)


def batch(x):
    return torch.from_numpy(np.asarray(x))


def copied(path):
    arr = np.load(path)
    return torch.asarray(arr, copy=True), torch.from_numpy(arr.astype(
        np.float32))
