from repro_torch.comm.transport import (  # noqa: F401
    CommAccountant, LinkClass, TransferRecord, WANTopology, LINKS, SITE_LINKS,
    link_for_site,
)
from repro_torch.comm.payload import (  # noqa: F401
    deserialize_tree, serialize_tree, tree_bytes,
)
