"""Dataset markup readers — image paths + ground-truth polygons/types (numpy only).

Counterpart of ``ubdvss_tpu/markup.py``: per-dataset reader classes that
return, per image, a list of barcode polygons with their type labels, plus
a reader registry/factory.  The on-disk formats are the JAX package's:

  * JSON ("zvz-json"): one ``markup.json`` per dataset root:
      {"image.png": [{"type": "QRCode",
                      "points": [[x, y], ...]}, ...], ...}
  * XML ("zvz-xml"): per-image sidecar ``<image>.xml``:
      <image name="image.png">
        <barcode type="QRCode"><point x="1" y="2"/>...</barcode>
      </image>
  * Synthetic ("synthetic"): the port's procedurally generated scenes
    (``ubdvss_tpu_torch.synthetic``).

Everything downstream consumes only the ``Sample`` interface.
"""

from __future__ import annotations

import dataclasses
import json
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class BarcodeObject:
    """One ground-truth barcode: polygon in input-image coords + type."""

    points: np.ndarray  # (N, 2) float32, (x, y)
    type_name: str


@dataclasses.dataclass
class Sample:
    image_path: str
    objects: list[BarcodeObject]
    # in-memory image (synthetic datasets); loaded from image_path when None
    image: np.ndarray | None = None

    @property
    def polygons(self) -> list[np.ndarray]:
        return [o.points for o in self.objects]

    @property
    def types(self) -> list[str]:
        return [o.type_name for o in self.objects]


class MarkupReader:
    """Base reader interface."""

    def samples(self) -> list[Sample]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.samples())


class JsonMarkupReader(MarkupReader):
    """``markup.json`` at the dataset root; image paths relative to root."""

    def __init__(self, root: str | Path, markup_name: str = "markup.json"):
        self.root = Path(root)
        with open(self.root / markup_name) as f:
            raw = json.load(f)
        self._samples = [
            Sample(
                image_path=str(self.root / name),
                objects=[
                    BarcodeObject(
                        points=np.asarray(o["points"], np.float32),
                        type_name=o["type"],
                    )
                    for o in objs
                ],
            )
            for name, objs in sorted(raw.items())
        ]

    def samples(self) -> list[Sample]:
        return self._samples


class XmlMarkupReader(MarkupReader):
    """Per-image ``<stem>.xml`` sidecar files next to the images."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self._samples = []
        for xml_path in sorted(self.root.glob("**/*.xml")):
            img_el = ET.parse(xml_path).getroot()
            objs = []
            for bc in img_el.findall("barcode"):
                pts = np.asarray(
                    [[float(p.get("x")), float(p.get("y"))] for p in bc.findall("point")],
                    np.float32,
                )
                objs.append(BarcodeObject(points=pts, type_name=bc.get("type")))
            self._samples.append(
                Sample(image_path=str(xml_path.parent / img_el.get("name")), objects=objs)
            )

    def samples(self) -> list[Sample]:
        return self._samples


_READERS: dict[str, type] = {
    "zvz-json": JsonMarkupReader,
    "zvz-xml": XmlMarkupReader,
}


def register_reader(name: str, cls: type) -> None:
    _READERS[name] = cls


def get_markup_reader(format_name: str, root: str | Path, **kw) -> MarkupReader:
    """Reader factory: a registered format, or "synthetic" (the port's
    ``SyntheticMarkupReader``, ``root`` ignored)."""
    if format_name == "synthetic":
        from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

        return SyntheticMarkupReader(root, **kw)
    try:
        cls = _READERS[format_name]
    except KeyError:
        raise ValueError(
            f"unknown markup format {format_name!r}; known: "
            f"{sorted(_READERS) + ['synthetic']}"
        ) from None
    return cls(root, **kw)


def write_json_markup(root: str | Path, markup: dict, name: str = "markup.json"):
    """Write a ``markup.json`` (the synthetic generator's and the tests' helper)."""
    with open(Path(root) / name, "w") as f:
        json.dump(markup, f)
