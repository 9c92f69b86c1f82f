"""Barnes-Hut t-SNE on the digits dataset + live dashboard scatter (the
reference's t-SNE tutorial + TsneModule view). Run: python -m
deeplearning4j_tpu_torch.examples.12_tsne_visualization [--device cpu]"""
import numpy as np

from deeplearning4j_tpu_torch.examples._common import (
    cli, device_of, load_digits,
)
from deeplearning4j_tpu_torch.manifold import BarnesHutTsne


def main(n=500, max_iter=350, serve=False, device=None):
    dev = device_of(device)
    images, target = load_digits()
    X = (images[:n].reshape(n, -1) / 16.0).astype("float32")
    labels = target[:n]
    tsne = BarnesHutTsne(perplexity=25, theta=0.5, max_iter=max_iter,
                         seed=7, device=dev)
    Y = tsne.fit_transform(X)
    # neighbor purity: how often the nearest embedded point shares a digit
    d2 = ((Y[:, None] - Y[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    purity = (labels[d2.argmin(1)] == labels).mean()
    print(f"KL={tsne.kl_divergence_:.4f}  1-NN purity={purity:.3f}")
    if serve:
        from deeplearning4j_tpu_torch.ui import UIServer
        server = UIServer.get_instance()
        server.post_tsne("digits", Y, labels=[str(c) for c in labels])
        print(f"view at {server.url}tsne")
    return purity


if __name__ == "__main__":
    cli(main, serve=True)
    input("serving — press enter to exit\n")
