from .dart import DART
from .gbdt import GBDT
from .goss import GOSS


def create_boosting(boosting_type: str, device):
    """Boosting::CreateBoosting (src/boosting/boosting.cpp): the booster
    class for ``boosting_type``; GBDT for any type it does not take, whose
    ``init`` then names it."""
    return {"goss": GOSS, "dart": DART}.get(boosting_type.lower(), GBDT)(device)


__all__ = ["DART", "GBDT", "GOSS", "create_boosting"]
