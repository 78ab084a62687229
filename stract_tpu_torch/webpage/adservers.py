"""Ad/tracker detection (role of reference webpage/adservers.rs + TrackerScore
signal): counts third-party requests to known ad/tracking hosts."""

from __future__ import annotations

from urllib.parse import urlparse

AD_HOSTS = {
    "doubleclick.net", "googlesyndication.com", "googleadservices.com",
    "google-analytics.com", "googletagmanager.com", "adnxs.com", "adsafeprotected.com",
    "amazon-adsystem.com", "criteo.com", "criteo.net", "outbrain.com", "taboola.com",
    "scorecardresearch.com", "quantserve.com", "moatads.com", "rubiconproject.com",
    "pubmatic.com", "openx.net", "casalemedia.com", "adsrvr.org", "facebook.net",
    "hotjar.com", "mixpanel.com", "segment.io", "chartbeat.com", "newrelic.com",
}


def _host_of(url: str) -> str:
    try:
        h = urlparse(url if "://" in url else f"https://{url}").netloc.lower()
    except ValueError:
        return ""
    return h[4:] if h.startswith("www.") else h


def is_ad_host(url: str) -> bool:
    h = _host_of(url)
    return any(h == ad or h.endswith("." + ad) for ad in AD_HOSTS)


def count_trackers(resource_urls: list[str]) -> int:
    return sum(1 for u in resource_urls if is_ad_host(u))


def likely_has_ads(resource_urls: list[str]) -> bool:
    return count_trackers(resource_urls) > 0
