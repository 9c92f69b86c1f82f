"""Label-aware document iterators.

Parity: DL4J `text/documentiterator/` — `LabelledDocument`, `LabelsSource`,
`SimpleLabelAwareIterator`, `BasicLabelAwareIterator`,
`FileLabelAwareIterator` (one subdirectory per label),
`FilenamesLabelAwareIterator`. These feed the bag-of-words/TF-IDF
vectorizers and ParagraphVectors; they are host-side text plumbing, so they
stay plain Python on the host.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class LabelledDocument:
    """One document + its label(s) (DL4J LabelledDocument)."""
    content: str
    labels: List[str] = dataclasses.field(default_factory=list)

    @property
    def label(self) -> Optional[str]:
        return self.labels[0] if self.labels else None


class LabelsSource:
    """Ordered registry of the labels seen (DL4J LabelsSource): stable
    index per label, used to build one-hot label rows."""

    def __init__(self, template: str = "DOC_%d"):
        self.template = template
        self._labels: List[str] = []
        self._index = {}

    def store_label(self, label: str) -> int:
        if label not in self._index:
            self._index[label] = len(self._labels)
            self._labels.append(label)
        return self._index[label]

    def next_label(self) -> str:
        label = self.template % len(self._labels)
        self.store_label(label)
        return label

    def index_of(self, label: str) -> int:
        return self._index.get(label, -1)

    def size(self) -> int:
        return len(self._labels)

    def get_labels(self) -> List[str]:
        return list(self._labels)


class LabelAwareIterator:
    """Iterator of LabelledDocuments (DL4J LabelAwareIterator)."""

    labels_source: LabelsSource

    def documents(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError

    def reset(self):
        pass

    def __iter__(self):
        return self.documents()


class SimpleLabelAwareIterator(LabelAwareIterator):
    """Wraps an in-memory collection of (text, label) pairs or
    LabelledDocuments (DL4J SimpleLabelAwareIterator)."""

    def __init__(self, documents: Iterable):
        self._docs: List[LabelledDocument] = []
        self.labels_source = LabelsSource()
        for d in documents:
            if isinstance(d, LabelledDocument):
                doc = d
            else:
                text, label = d
                doc = LabelledDocument(text, [label])
            for lab in doc.labels:
                self.labels_source.store_label(lab)
            self._docs.append(doc)

    def documents(self):
        return iter(self._docs)


class BasicLabelAwareIterator(LabelAwareIterator):
    """Wraps a plain sentence iterator, generating synthetic labels
    DOC_0, DOC_1, ... (DL4J BasicLabelAwareIterator)."""

    def __init__(self, sentences: Iterable[str], template: str = "DOC_%d"):
        self.labels_source = LabelsSource(template)
        self._docs = []
        for s in sentences:
            label = self.labels_source.next_label()
            self._docs.append(LabelledDocument(s, [label]))

    def documents(self):
        return iter(self._docs)


class FileLabelAwareIterator(LabelAwareIterator):
    """Directory tree where each SUBDIRECTORY is a label and each file in
    it a document (DL4J FileLabelAwareIterator)."""

    def __init__(self, root: str):
        self.root = root
        self.labels_source = LabelsSource()
        self._files: List[Tuple[str, str]] = []
        for label in sorted(os.listdir(root)):
            d = os.path.join(root, label)
            if not os.path.isdir(d):
                continue
            self.labels_source.store_label(label)
            for fname in sorted(os.listdir(d)):
                path = os.path.join(d, fname)
                if os.path.isfile(path):
                    self._files.append((path, label))

    def documents(self):
        for path, label in self._files:
            with open(path, encoding="utf-8") as f:
                yield LabelledDocument(f.read(), [label])


class FilenamesLabelAwareIterator(LabelAwareIterator):
    """Flat directory: every file is a document, its filename the label
    (DL4J FilenamesLabelAwareIterator)."""

    def __init__(self, root: str):
        self.root = root
        self.labels_source = LabelsSource()
        self._files = []
        for fname in sorted(os.listdir(root)):
            path = os.path.join(root, fname)
            if os.path.isfile(path):
                self.labels_source.store_label(fname)
                self._files.append((path, fname))

    def documents(self):
        for path, label in self._files:
            with open(path, encoding="utf-8") as f:
                yield LabelledDocument(f.read(), [label])
