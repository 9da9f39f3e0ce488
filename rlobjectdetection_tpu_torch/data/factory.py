"""Dataset factory: name → imdb constructor (copy of the JAX package's
`data/factory.py`).

voc_{2007,2012}_{train,val,trainval,test}, coco_2014_{train,val,minival,
valminusminival} and coco_2015_{test,test-dev}. The imagenet and vg names
stay unregistered until their modules are ported (ROADMAP §1 item 17b);
`get_imdb` raises KeyError for them, as for any unknown name.
"""

from __future__ import annotations

__sets = {}


def _register():
    from .coco import coco
    from .pascal_voc import pascal_voc

    for year in ["2007", "2012"]:
        for split in ["train", "val", "trainval", "test"]:
            name = f"voc_{year}_{split}"
            __sets[name] = (lambda split=split, year=year: pascal_voc(split, year))

    for year in ["2014"]:
        for split in ["train", "val", "minival", "valminusminival"]:
            name = f"coco_{year}_{split}"
            __sets[name] = (lambda split=split, year=year: coco(split, year))

    for year in ["2015"]:
        for split in ["test", "test-dev"]:
            name = f"coco_{year}_{split}"
            __sets[name] = (lambda split=split, year=year: coco(split, year))


def get_imdb(name: str):
    """Get an imdb by name (factory.py:62-67)."""
    if not __sets:
        _register()
    if name not in __sets:
        raise KeyError(f"Unknown dataset: {name}")
    return __sets[name]()


def list_imdbs():
    if not __sets:
        _register()
    return list(__sets.keys())
