/* Progressive-image push client: the SSE analogue of the reference's
   SocketIO 'image_update' handler (download_image_udp.py:49-54). */
const es = new EventSource('/events');
es.onmessage = (e) => {
  const d = JSON.parse(e.data);
  document.getElementById('im').src = 'data:image/jpeg;base64,' + d.image;
  if (d.pieces !== undefined)
    document.getElementById('count').textContent = d.pieces;
};
