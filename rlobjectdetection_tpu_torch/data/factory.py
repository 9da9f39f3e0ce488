"""Dataset factory: name → imdb constructor (copy of the JAX package's
`data/factory.py`).

voc_{2007,2012}_{train,val,trainval,test}, coco_2014_{train,val,minival,
valminusminival}, coco_2015_{test,test-dev}, imagenet_{train,val,val1,val2,
test} and vg_<version>_<split> for the 6 vocabulary versions and 7 splits.
`get_imdb` raises KeyError for any other name.
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

    from .imagenet import imagenet
    from .vg import vg

    for split in ["train", "val", "val1", "val2", "test"]:
        name = f"imagenet_{split}"
        __sets[name] = (lambda split=split: imagenet(split))

    for version in ["150-50-20", "150-50-50", "500-150-80", "750-250-150",
                    "1750-700-450", "1600-400-20"]:
        for split in ["minitrain", "smalltrain", "train", "minival",
                      "smallval", "val", "test"]:
            name = f"vg_{version}_{split}"
            __sets[name] = (lambda split=split, version=version: vg(version, split))


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
