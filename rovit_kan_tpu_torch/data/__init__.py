"""Datasets, loaders and transforms of the port."""
from rovit_kan_tpu_torch.data.dataset import (  # noqa: F401
    Loader,
    RoseLeafDataset,
    Subset,
    create_dataloaders,
)
from rovit_kan_tpu_torch.data.device_cache import (  # noqa: F401
    DeviceLoader,
    device_cache_loaders,
)
from rovit_kan_tpu_torch.data.resize import resize_image  # noqa: F401
from rovit_kan_tpu_torch.data.synthetic import (  # noqa: F401
    generate_synthetic_dataset,
    make_leaf_image,
)
from rovit_kan_tpu_torch.data.transforms import (  # noqa: F401
    augmented_transforms,
    cutmix_or_mixup,
    inference_transforms,
    original_transforms,
)
