from repro_torch.comm.transport import (  # noqa: F401
    CommAccountant, LinkClass, TransferRecord, WANTopology, LINKS, SITE_LINKS,
    link_for_site,
)
