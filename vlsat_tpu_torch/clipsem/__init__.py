from vlsat_tpu_torch.clipsem.prompts import (  # noqa: F401
    no_relation_prompt,
    object_prompt,
    relation_prompt,
    triplet_prompt,
)
from vlsat_tpu_torch.clipsem.text_tables import (  # noqa: F401
    HF_MISSING,
    HashTextEncoder,
    TripletTextCache,
    build_label_tables,
)
